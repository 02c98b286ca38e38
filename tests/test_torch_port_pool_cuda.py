"""K4 on the card at the kernels no shape of test_torch_port_guards.py's
K4_CASES reaches in 16-byte units: the 4^3 window (the staged kernel
unrolled for w = 4), windows of 5 and more and the 1^3 window (the generic
kernel), at C = 64 in float32, bfloat16 and float16; and the blocks an SM
holds as the card counts them (`card_geometry`). Every test here needs a
CUDA device and skips without one."""

import pytest
import torch

from multimodal_ad_tpu_torch.ops import pool as tk4
from test_torch_port_support import cap_torch_threads

cap_torch_threads()

WIDE_CASES = [  # (window, padding, shape), C = 64: 16-byte units in every type
    (4, 1, (1, 11, 9, 10, 64)), (4, 2, (2, 8, 9, 7, 64)), (5, 2, (1, 11, 9, 10, 64)),
    (6, 1, (1, 9, 12, 8, 64)), (1, 0, (2, 7, 6, 5, 64)),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("window,padding,shape", WIDE_CASES,
                         ids=[f"{w}^3p{p}" for w, p, _ in WIDE_CASES])
def test_k4_wide_units_match_plain(cuda, dtype, window, padding, shape):
    """On tie-free and ReLU'd (tied) inputs: equal to the plain version
    computed in float32 and rounded once to the type (bit for bit in
    float32 itself); two launches bit-identical; 16-byte units taken."""
    g = torch.Generator().manual_seed(sum(shape) + window)
    size = torch.empty((), dtype=dtype).element_size()
    assert tk4.k4_geometry(shape, size, window, padding).vec == 16 // size
    for relu in (False, True):
        x = torch.randn(shape, generator=g)
        x = (x.clamp(min=0) if relu else x).to(cuda, dtype)
        y = tk4.max_pool_3d_fast(x, window, 2, padding)
        gy = torch.randn(tuple(y.shape), generator=g).to(cuda, dtype)
        before = tk4.max_pool_3d_fast_backward.launches
        a = tk4.max_pool_3d_fast_backward(x, y, gy, window, padding)
        b = tk4.max_pool_3d_fast_backward(x, y, gy, window, padding)
        torch.cuda.synchronize()
        assert tk4.max_pool_3d_fast_backward.launches == before + 2
        assert a.dtype == dtype and a.shape == x.shape and torch.equal(a, b)
        ref32 = tk4.max_pool_3d_fast_plain(x.float(), y.float(), gy.float(), window, padding)
        assert torch.equal(a, ref32.to(dtype)), (
            f"relu={relu}: max diff {float((a.float() - ref32.to(dtype).float()).abs().max()):.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("window,padding,shape,dtype", [
    (3, 1, (8, 46, 55, 46, 64), torch.bfloat16), (3, 1, (8, 46, 55, 46, 64), torch.float32),
    (2, 0, (2, 96, 112, 96, 64), torch.bfloat16)], ids=["stem bf16", "stem f32", "unet bf16"])
def test_card_counts_blocks_per_sm(cuda, window, padding, shape, dtype):
    """The card's count of the launched kernel's blocks an SM holds is at
    least the budget k4_geometry assumes without a card, and the grid it
    cuts holds MIN_WAVES waves of them."""
    x = torch.empty(shape, dtype=dtype, device=cuda)
    geo = tk4.card_geometry(x, window, padding)
    budget = tk4.k4_geometry(shape, x.element_size(), window, padding)
    assert geo.per_sm >= budget.per_sm >= 1
    assert geo.waves >= tk4.MIN_WAVES
    if geo.path == "staged":  # shared memory holds two blocks an SM
        assert geo.per_sm == 2 and geo.kd == budget.kd
