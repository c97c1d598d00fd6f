"""The identity-stage kernel's host side on the CPU: the plan of
``stage_plan`` and the K-major weights of ``pack_stage_weights``.

Every plan covers each output pixel exactly once with one CTA a tile and
fits a Hopper block's shared memory; at the 448-px stage 2 its CTAs read
half the weight bytes the 8x8 / 4x14 tiling read from L2, and at stage 3 no
more.  The K-major copies hold the JAX stack's bits, and the stage computed
CTA by CTA as the kernel splits it (halo rows, y1 zero outside the image,
rows past the tile's pixels, edge tiles) gives the JAX Pallas kernel's
output (interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.ops import fused_resnet as J
from rau_vqa_tpu_torch.convert import params_from_jax
from rau_vqa_tpu_torch.ops import fused_resnet as P

N_SM = 132
# (H = W, C, Cw) of ResNet-101's four identity runs at 448 px
STAGES = [(112, 256, 64), (56, 512, 128), (28, 1024, 256), (14, 2048, 512)]
RAGGED = (9, 11, 13, 14, 21, 28)


def covered(plan, B, H, W):
    """How many CTAs store each output pixel [B, H, W]."""
    hits = torch.zeros(B, H, W, dtype=torch.int32)
    for cta in range(plan.ctas):
        img, ty0, tx0 = plan.cta_tile(cta)
        hits[img, ty0:ty0 + plan.th, tx0:tx0 + plan.tw] += 1
    return hits


def check_plan(plan, B, H, W, C, Cw):
    assert torch.all(covered(plan, B, H, W) == 1)
    assert plan.ctas == plan.tiles * B
    assert plan.smem == P.smem_bytes(plan.th, plan.tw, plan.nb, plan.ring, C, Cw)
    assert plan.smem <= P.SMEM_LIMIT == 232_448
    assert (plan.th, plan.tw, plan.nb, plan.ring) in P.INSTANCES
    assert Cw % plan.nb == 0
    assert plan.weight_bytes == plan.ctas * P.block_weight_bytes(C, Cw)


@pytest.mark.parametrize("H,C,Cw", STAGES)
@pytest.mark.parametrize("B", [1, 7, 120])
def test_plan_covers_each_pixel_once_at_the_448_px_stages(B, H, C, Cw):
    check_plan(P.stage_plan(B, H, H, C, Cw, N_SM), B, H, H, C, Cw)


@pytest.mark.parametrize("H", RAGGED)
@pytest.mark.parametrize("W", RAGGED)
@pytest.mark.parametrize("C,Cw", [(128, 64), (512, 256), (2048, 512)])
def test_plan_covers_each_pixel_once_at_ragged_shapes(H, W, C, Cw):
    for B in (1, 3):
        check_plan(P.stage_plan(B, H, W, C, Cw, N_SM), B, H, W, C, Cw)


@pytest.mark.parametrize("th,tw,nb,ring", P.INSTANCES)
@pytest.mark.parametrize("B", [1, 3])
def test_every_instance_plans_within_the_limits(th, tw, nb, ring, B):
    """Each instantiation, asked for by tile and ring at Cw = its column
    chunk, on an image its tiles do not divide."""
    H, W, C, Cw = 13, 21, 256, nb
    plan = P.stage_plan(B, H, W, C, Cw, N_SM, tile=(th, tw), ring=ring)
    assert (plan.th, plan.tw, plan.nb, plan.ring) == (th, tw, nb, ring)
    check_plan(plan, B, H, W, C, Cw)


def old_weight_bytes(B, H, W, C, Cw):
    """L2 weight bytes a block of the mma.sync kernel read: every CTA of its
    8x8 tiling (4x14 where that divides W and 8x8 does not) read all of a
    block's weights."""
    th, tw = (4, 14) if W % 8 and W % 14 == 0 else (8, 8)
    return -(-H // th) * -(-W // tw) * B * P.block_weight_bytes(C, Cw)


@pytest.mark.parametrize("H,C,Cw,fewer", [(28, 1024, 256, 2), (14, 2048, 512, 1)])
def test_plan_reads_fewer_weight_bytes_than_the_old_tiling_at_stages_2_and_3(H, C, Cw, fewer):
    """4x28 tiles halve stage 2's L2 weight reads; stage 3 keeps the 4x14
    tile.  (Multicast over a cluster cut them 2-4x more and was slower.)"""
    old = old_weight_bytes(120, H, H, C, Cw)
    assert P.stage_plan(120, H, H, C, Cw, N_SM).weight_bytes * fewer == old


@pytest.mark.parametrize("H,C,Cw", STAGES)
def test_plan_chooses_the_designed_tiles_at_the_448_px_stages(H, C, Cw):
    """4x28 tiles (4x14 where Cw = 512 leaves no room), the deepest ring
    that fits."""
    plan = P.stage_plan(120, H, H, C, Cw, N_SM)
    want = {112: ((4, 28), 3), 56: ((4, 28), 4), 28: ((4, 28), 3), 14: ((4, 14), 3)}
    assert ((plan.th, plan.tw), plan.ring) == want[H]


def test_plan_takes_the_deepest_ring_that_fits():
    deep = P.stage_plan(2, 56, 56, 512, 128, N_SM)
    assert deep.ring == 4 and deep.smem <= P.SMEM_LIMIT
    assert P.stage_plan(2, 56, 56, 512, 128, N_SM, ring=3).ring == 3
    # at stage 2 a fourth slot would not fit beside y1 and y2
    assert P.smem_bytes(4, 28, 128, 4, 1024, 256) > P.SMEM_LIMIT
    assert P.stage_plan(2, 28, 28, 1024, 256, N_SM).ring == 3


@pytest.mark.parametrize("kwargs,match", [
    (dict(C=96), "C % 128"), (dict(Cw=96), "multiple of 64"), (dict(Cw=576), "64..512"),
    (dict(Cw=32), "64..512"), (dict(B=0), "B, H, W"), (dict(H=0), "B, H, W"),
    (dict(ring=5), "no instantiated tile with a 5-deep ring"), (dict(tile=(5, 5)), "no kernel"),
    (dict(tile=(4, 14), ring=4), "no kernel"), (dict(Cw=512, tile=(4, 28)), "no instantiated tile"),
])
def test_plan_rejects_shapes_the_kernel_does_not_take(kwargs, match):
    args = dict(B=2, H=14, W=14, C=256, Cw=128)
    extra = {k: kwargs.pop(k) for k in ("tile", "ring") if k in kwargs}
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        P.stage_plan(args["B"], args["H"], args["W"], args["C"], args["Cw"], N_SM, **extra)


def blocks(rs, n, c, cw, b1_shift=0.0):
    """Folded identity-block trees as float32 numpy arrays (the shapes of
    tests/test_fused_resnet.py:28-38), ``b1_shift`` added to the reduce's
    bias so that relu(b1) differs from the zero halo."""
    def blk():
        return {"conv1": {"w": rs.randn(1, 1, c, cw) * .1, "b": rs.randn(cw) * .1 + b1_shift},
                "conv2": {"w": rs.randn(3, 3, cw, cw) * .05, "b": rs.randn(cw) * .1},
                "conv3": {"w": rs.randn(1, 1, cw, c) * .1, "b": rs.randn(c) * .1}}
    return [jax.tree.map(lambda a: a.astype(np.float32), blk()) for _ in range(n)]


def test_k_major_weights_hold_the_jax_stack_bits():
    bl = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                      blocks(np.random.RandomState(5), 3, 128, 64))
    want = jax.tree.map(np.asarray, J.stack_identity_blocks(bl))
    kmaj = P.pack_stage_weights(P.stack_identity_blocks(params_from_jax(bl)))

    def bits(t):
        return t.view(torch.int16).numpy()

    def jbits(a):
        return a.view(np.int16)

    N, C, Cw = want["w1"].shape
    assert kmaj["w1t"].shape == (N, Cw, C) and kmaj["w1t"].is_contiguous()
    np.testing.assert_array_equal(bits(kmaj["w1t"]), jbits(want["w1"]).transpose(0, 2, 1))
    np.testing.assert_array_equal(
        bits(kmaj["w2t"]), jbits(want["w2"]).transpose(0, 1, 3, 2).reshape(N, 9 * Cw, Cw))
    np.testing.assert_array_equal(bits(kmaj["w3t"]), jbits(want["w3"]).transpose(0, 2, 1))


def emulate(x, stack, plan):
    """The stage as the kernel splits it, in float32: each CTA takes its
    tile's halo (zeros outside the image), y1 =
    0 outside the image, the 3x3 over the plan's 128 or 64 rows of the halo
    grid (tap (dy, dx) reads y1 from row r + dy (tw + 2) + dx on; y1 reads
    NaN past the halo, so that a stored pixel that read there shows), the
    expand from the K-major weights, and stores only the rows that are
    pixels inside the image."""
    B, H, W, C = x.shape
    kmaj = P.pack_stage_weights(stack)
    th, tw = plan.th, plan.tw
    hw = tw + 2
    mrows, m = P.tile_rows(th, tw)
    r = torch.arange(m)
    py, px = r // hw, r % hw
    stored = (r < mrows) & (px < tw)
    h = x.float()
    for n in range(stack["w1"].shape[0]):
        w1t, w2t, w3t = (kmaj[k][n].float() for k in ("w1t", "w2t", "w3t"))
        b1, b2, b3 = (stack[k][n, 0].float() for k in ("b1", "b2", "b3"))
        Cw = w1t.shape[0]
        out = torch.full_like(h, float("nan"))
        for cta in range(plan.ctas):
            img, ty0, tx0 = plan.cta_tile(cta)
            hy = torch.arange(ty0 - 1, ty0 + th + 1)[:, None].expand(th + 2, hw)
            hx = torch.arange(tx0 - 1, tx0 + tw + 1)[None, :].expand(th + 2, hw)
            inside = (hy >= 0) & (hy < H) & (hx >= 0) & (hx < W)
            xh = torch.zeros(th + 2, hw, C)
            xh[inside] = h[img, hy[inside], hx[inside]]
            y1 = (torch.relu(xh @ w1t.T + b1) * inside[..., None]).reshape(-1, Cw)
            y1 = torch.cat([y1, torch.full((m + 2 * hw + 2, Cw), float("nan"))])
            acc = torch.zeros(m, Cw)
            for t in range(9):
                dy, dx = divmod(t, 3)
                acc = acc + y1[r + dy * hw + dx] @ w2t[t * Cw:(t + 1) * Cw].T
            y2 = torch.relu(acc + b2)
            oy, ox = ty0 + py, tx0 + px
            keep = stored & (oy < H) & (ox < W)
            if not keep.any():
                continue
            oy, ox = oy[keep], ox[keep]
            out[img, oy, ox] = torch.relu((h[img, oy, ox] + y2[keep] @ w3t.T) + b3)
        assert not torch.isnan(out).any(), "a pixel no CTA stored, or one read past the halo"
        h = out
    return h


@pytest.mark.parametrize("tile,B", [((4, 28), 1), ((4, 28), 3), ((4, 14), 3)])
def test_tile_by_tile_stage_matches_the_pallas_kernel(tile, B):
    rs = np.random.RandomState(6)
    H, W, C, Cw, N = 9, 11, 128, 64, 2
    bl = blocks(rs, N, C, Cw, b1_shift=0.5)
    x = np.abs(rs.randn(B, H, W, C)).astype(np.float32)
    want = J.fused_identity_stage(jnp.asarray(x), J.stack_identity_blocks(jax.tree.map(
        jnp.asarray, bl)), block_b=1, interpret=True)
    stack = P.stack_identity_blocks(params_from_jax(bl))
    plan = P.stage_plan(B, H, W, C, Cw, N_SM, tile=tile)
    got = emulate(torch.as_tensor(x), stack, plan)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_cpu_tensor_with_a_plan_runs_the_plain_version():
    rs = np.random.RandomState(7)
    bl = blocks(rs, 1, 128, 64)
    stack = P.stack_identity_blocks(params_from_jax(bl))
    x = torch.as_tensor(np.abs(rs.randn(1, 5, 6, 128)).astype(np.float32))
    launches = P.KERNEL.launches
    got = P.fused_identity_stage(x, stack, block_b=1, plan=P.stage_plan(1, 5, 6, 128, 64, N_SM))
    assert P.KERNEL.launches == launches
    torch.testing.assert_close(got, P.fused_identity_stage_reference(x, stack))
