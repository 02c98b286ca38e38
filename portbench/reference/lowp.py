"""The reference computed in a lower precision than a configuration states:
the controls that the check of `correct` has to refuse.

- `fp8`: a fake-quantising cast of a tensor to float8 e4m3 (a per-tensor
  scale to its largest value, 448), with the straight-through gradient, for
  the bf16 training cells: the reference in fp8 in the program's place;
- the int8 serving cells' control is the int8 reference at 4 bits
  (`portbench/reference/int8.py`, ``levels=7``).
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def fp8(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded through float8 e4m3 with a per-tensor scale, the
    gradient passed straight through."""
    s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x).detach()
