"""The port's identity-stage wrapper against the JAX package's Pallas stage
kernel, on the CPU.

On a CPU tensor ``fused_identity_stage`` runs its plain version
(``fused_identity_stage_reference``); the JAX side runs
``fused_identity_stage(interpret=True)``, as tests/test_fused_resnet.py does.
Bars are that file's: 2e-5 in float32 (:54-55) and 0.1 in bf16 (:70-72).
The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.ops import fused_resnet as J
from rau_vqa_tpu_torch.convert import params_from_jax
from rau_vqa_tpu_torch.ops import fused_resnet as P


def blocks(rs, n, c, cw, b1_shift=0.0):
    """Folded identity-block trees as numpy arrays (tests/test_fused_resnet.py
    :28-38), with ``b1_shift`` added to the reduce's bias."""
    def blk():
        return {
            "conv1": {"w": rs.randn(1, 1, c, cw) * .2, "b": rs.randn(cw) * .1 + b1_shift},
            "conv2": {"w": rs.randn(3, 3, cw, cw) * .2, "b": rs.randn(cw) * .1},
            "conv3": {"w": rs.randn(1, 1, cw, c) * .2, "b": rs.randn(c) * .1},
        }
    return [jax.tree.map(lambda a: a.astype(np.float32), blk()) for _ in range(n)]


def run_both(x, bl, dtype, block_b):
    """The JAX kernel (interpreted) and the port's wrapper on one input."""
    jbl = jax.tree.map(lambda a: jnp.asarray(a, dtype), bl)
    want = J.fused_identity_stage(jnp.asarray(x, dtype), J.stack_identity_blocks(jbl),
                                  block_b=block_b, interpret=True)
    tbl = params_from_jax(jax.tree.map(np.asarray, jbl))
    xt = params_from_jax(np.asarray(jnp.asarray(x, dtype)))
    got = P.fused_identity_stage(xt, P.stack_identity_blocks(tbl), block_b=block_b)
    return got, np.asarray(want)


@pytest.mark.parametrize("block_b", [1, 2, 4])
def test_plain_stage_matches_jax_f32(block_b):
    rs = np.random.RandomState(0)
    B, H, W, C, Cw, N = 4, 6, 6, 32, 8, 3
    bl = blocks(rs, N, C, Cw)
    x = rs.randn(B, H, W, C).astype(np.float32)
    launches = P.KERNEL.launches
    got, want = run_both(x, bl, jnp.float32, block_b)
    assert P.KERNEL.launches == launches     # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_plain_stage_matches_jax_bf16():
    rs = np.random.RandomState(1)
    bl = blocks(rs, 2, 32, 8)
    x = rs.randn(2, 4, 4, 32).astype(np.float32)
    got, want = run_both(x, bl, jnp.bfloat16, 1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=0.1, atol=0.1)


def _pad_with_relu_b1(x, stack):
    """The wrong halo: the 3x3 padded with relu(b1), as if the reduce ran
    over a zero-padded input."""
    h = x.float()
    B, H, W, C = h.shape
    for n in range(stack["w1"].shape[0]):
        w1, b1, w2, b2, w3, b3 = (stack[k][n].float() for k in P._KEYS)
        y1 = torch.relu(h @ w1 + b1[0])
        y1p = torch.relu(b1[0]).expand(B, H + 2, W + 2, -1).clone()
        y1p[:, 1:H + 1, 1:W + 1] = y1
        acc = b2[0]
        for t in range(9):
            dy, dx = divmod(t, 3)
            acc = acc + y1p[:, dy:dy + H, dx:dx + W] @ w2[t]
        h = torch.relu(h + torch.relu(acc) @ w3 + b3[0])
    return h


@pytest.mark.parametrize("b1_shift", [1.0, -1.0])
def test_halo_is_zero_in_y1(b1_shift):
    """Halo pixels outside the image are 0 in y1, not relu(b1): with b1 > 0
    the two differ at every border pixel, and the port agrees with the JAX
    kernel; with b1 < 0 (relu(b1) = 0) the two coincide."""
    rs = np.random.RandomState(2)
    bl = blocks(rs, 2, 32, 8, b1_shift=b1_shift)
    x = rs.randn(2, 5, 7, 32).astype(np.float32)
    got, want = run_both(x, bl, jnp.float32, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    stack = P.stack_identity_blocks(params_from_jax(bl))
    wrong = _pad_with_relu_b1(torch.as_tensor(x), stack)
    gap = (wrong - got).abs().amax(-1)            # [B, H, W]
    if b1_shift > 0:
        assert gap[:, 0].min() > 1e-2 and gap[:, -1].min() > 1e-2
        assert gap[:, :, 0].min() > 1e-2 and gap[:, :, -1].min() > 1e-2
    else:
        assert gap.max() < 1e-4


def test_stack_identity_blocks_matches_jax():
    bl = blocks(np.random.RandomState(3), 3, 16, 8)
    want = J.stack_identity_blocks(jax.tree.map(jnp.asarray, bl))
    got = P.stack_identity_blocks(params_from_jax(bl))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_pick_block_b_matches_jax():
    for batch in range(1, 21):
        for want in range(0, 10):
            assert P.pick_block_b(batch, want) == J.pick_block_b(batch, want)


def test_batch_must_divide_block_b():
    bl = blocks(np.random.RandomState(4), 1, 32, 8)
    stack = P.stack_identity_blocks(params_from_jax(bl))
    with pytest.raises(ValueError, match="not divisible"):
        P.fused_identity_stage(torch.zeros(3, 4, 4, 32), stack, block_b=2)
