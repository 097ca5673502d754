"""The port's kernels and their plain versions.

Importing this package registers every kernel's forward as a
`torch.library.custom_op` in the `simpb` namespace (`conv_fused`:
K1-K4; `sampling`: DFA, MSDA-sel, exact MSDA, H1, H2 and H3's two
instances). An exported serving program (`utils/export.py`) calls
these ops, so loading one needs this package and nothing of
`simpb_tpu_torch.models`.
"""
from . import conv_fused, sampling  # noqa: F401  (the op registrations)
