"""GridMask image augmentation (port of `simpb_tpu/models/grid_mask.py`).

The released settings: strips along both axes, no rotation, no offset,
ratio 0.5, mode 1 (the strip cells are kept), applied with probability
0.7. `keep_mask` is the pure mask; `grid_mask_draws` makes the four
draws from a `torch.Generator` (or a caller passes its own, as a test
feeds JAX's).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch


def keep_mask(h: int, w: int, d: int, l: int, st_h: int, st_w: int,
              device=None) -> torch.Tensor:
    """[h, w] bool mode-1 keep mask for the strip parameters, cropped
    from the centre of a 1.5x canvas with only canvas // d strips."""
    hh, ww = int(1.5 * h), int(1.5 * w)
    ys = torch.arange(h, device=device) + (hh - h) // 2
    xs = torch.arange(w, device=device) + (ww - w) // 2

    def strip(idx, st, canvas):
        rel = idx - st
        return (rel >= 0) & (rel % d < l) & (rel // d < canvas // d)

    return strip(ys, st_h, hh)[:, None] | strip(xs, st_w, ww)[None, :]


def grid_mask_draws(generator: torch.Generator, h: int
                    ) -> Tuple[float, int, int, int]:
    """(apply uniform, d in [2, h), st_h in [0, d), st_w in [0, d))."""
    u = float(torch.rand((), generator=generator))
    d = int(torch.randint(2, h, (), generator=generator))
    st_h = int(torch.randint(0, d, (), generator=generator))
    st_w = int(torch.randint(0, d, (), generator=generator))
    return u, d, st_h, st_w


def grid_mask(rng: Union[torch.Generator, Tuple[float, int, int, int]],
              images: torch.Tensor,  # [..., H, W, C]
              ratio: float = 0.5, prob: float = 0.7) -> torch.Tensor:
    h, w = images.shape[-3], images.shape[-2]
    u, d, st_h, st_w = (grid_mask_draws(rng, h)
                        if isinstance(rng, torch.Generator) else rng)
    if not u <= prob:
        return images
    l = min(max(int(d * ratio + 0.5), 1), d - 1)
    keep = keep_mask(h, w, d, l, st_h, st_w, images.device)
    return images * keep.to(images.dtype)[..., None]
