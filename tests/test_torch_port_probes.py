"""The port's probe tool against the JAX package's TPU compiler probes.

`tools/mosaic_probe.py` (loaded by path; it is a script, not a package
module) runs each Pallas probe under `force_tpu_interpret_mode` on the
CPU. Each of the port's plain versions (the CUDA kernels' reference in
`simpb_tpu_torch/tools/mosaic_probe.py`) must equal the probe's output
and its `ref` exactly: bf16 through fp32 is a copy. The kernels
themselves are held to the plain versions on the card by chip_smoke.py.
"""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from simpb_tpu_torch.tools import mosaic_probe as tprobe

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = [p[0] for p in tprobe.PROBES]


@pytest.fixture(scope="module")
def jax_probes():
    spec = importlib.util.spec_from_file_location(
        "jax_mosaic_probe", os.path.join(REPO, "tools", "mosaic_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {
        "P1_lane64": functools.partial(mod.p_lane, 64),
        "P1_lane256": functools.partial(mod.p_lane, 256),
        "P2_chunk4d": mod.p_chunk,
        "P4_value_reshape": mod.p_reshape,
        "P5_outer_stride_bf16": mod.p_outer_bf16,
        "P6_ref_reshape_unit_select": mod.p_refshape,
        "P7_chunk_flat3d": mod.p_chunk_flat,
    }


@pytest.mark.parametrize("label", LABELS)
def test_probe_plain_matches_pallas(jax_probes, label):
    _, _, plain, c, _ = tprobe.PROBES[LABELS.index(label)]
    with pltpu.force_tpu_interpret_mode():
        out, ref = jax_probes[label]()
    got = plain(tprobe.mk((1, tprobe.H, tprobe.W, c))).float().numpy()
    np.testing.assert_array_equal(got, np.asarray(out, np.float32))
    np.testing.assert_array_equal(got, np.asarray(ref, np.float32))


def test_probe_tool_runs_on_cpu(capsys):
    """On CPU tensors the wrappers take their plain versions: every line
    is OK, untimed, and no kernel is launched."""
    tprobe.reset_launch_counts()
    assert tprobe.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu"
    assert [ln.split(":")[0] for ln in lines[1:]] == LABELS
    assert all(": OK (plain version, untimed)" in ln for ln in lines[1:])
    assert set(tprobe.launch_counts().values()) == {0}
    assert [r["ms"] for r in tprobe.run("cpu")] == [None] * len(LABELS)


def test_probe_wrappers_refuse_other_devices():
    x = tprobe.mk((1, 4, 4, 128)).to("meta")
    for wrapper in tprobe.WRAPPERS:
        with pytest.raises(ValueError, match="CPU or CUDA"):
            wrapper(x)
