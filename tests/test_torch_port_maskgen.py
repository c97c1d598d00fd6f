"""The port's counter-hash dropout masks (rau_vqa_tpu_torch/ops/maskgen.py)
against the JAX package's (rau_vqa_tpu/ops/maskgen.py), on the CPU: every
function bit for bit, over shapes, row offsets, rates and seeds up to
2^31 - 1, and the masks' independence of the batch tiling.  The device hash
(csrc/maskgen.cuh) is held against the same plain version on the card, in
tests/test_torch_port_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.ops import maskgen as jmask
from rau_vqa_tpu_torch.ops import maskgen as tmask

SEEDS = [0, 1, 12345, 2 ** 31 - 2, 2 ** 31 - 1]


def test_mix32_bit_exact():
    rs = np.random.RandomState(0)
    x = np.concatenate([np.arange(4096, dtype=np.uint32),
                        rs.randint(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32),
                        np.array([2 ** 32 - 1, 2 ** 31, 2 ** 31 - 1], np.uint32)])
    want = np.asarray(jmask.mix32(jnp.asarray(x)))
    got = tmask.mix32(torch.as_tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_site_salt_bit_exact(seed):
    for hop in range(9):
        for site in range(3):
            want = int(np.asarray(jmask.site_salt(jnp.asarray(seed, jnp.int32),
                                                  hop, site)))
            assert int(tmask.site_salt(seed, hop, site)) == want
            # an int32 tensor seed, as the kernels' wrappers hand it over
            seed_t = torch.tensor([seed], dtype=torch.int32)
            assert int(tmask.site_salt(seed_t, hop, site)) == want


@pytest.mark.parametrize("shape,row_offset", [
    ((8, 196, 512), 0), ((3, 6, 12), 5), ((19, 2048), 81), ((4, 16), 2 ** 20),
    ((7, 3, 5, 2), 13)])
def test_counter_bits_bit_exact(shape, row_offset):
    for seed in (0, 2 ** 31 - 1):
        salt_j = jmask.site_salt(jnp.asarray(seed, jnp.int32), 3, 1)
        want = np.asarray(jmask.counter_bits(shape, row_offset, salt_j))
        got = tmask.counter_bits(shape, row_offset, tmask.site_salt(seed, 3, 1))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("rate", [0.0, 1e-9, 0.25, 0.5, 0.75, 1.0 - 2 ** -24])
@pytest.mark.parametrize("seed", SEEDS)
def test_dropout_scale_mask_bit_exact(rate, seed):
    shape, row_offset = (6, 5, 12), 3
    salt_j = jmask.site_salt(jnp.asarray(seed, jnp.int32), 7, 0)
    want = np.asarray(jmask.dropout_scale_mask(shape, row_offset, salt_j, rate))
    got = tmask.dropout_scale_mask(shape, row_offset,
                                   tmask.site_salt(seed, 7, 0), rate)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_mask_tile_invariance():
    """The bits of an element depend on its global index only: tiles of the
    batch at their row offsets reassemble the whole batch's mask."""
    salt = tmask.site_salt(99, 0, 0)
    full = tmask.dropout_scale_mask((10, 5, 7), 0, salt, 0.5)
    parts = [tmask.dropout_scale_mask((n, 5, 7), r0, salt, 0.5)
             for r0, n in ((0, 3), (3, 4), (7, 3))]
    torch.testing.assert_close(torch.cat(parts), full, rtol=0, atol=0)


def test_dropout_mask_cpu_runs_plain_version():
    seed = torch.tensor([4242], dtype=torch.int32)
    got = tmask.dropout_mask(seed, 2, 1, (5, 64), 11, 0.5)
    want = tmask.dropout_scale_mask((5, 64), 11, tmask.site_salt(4242, 2, 1), 0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tmask.KERNEL.launches == 0


def test_keep_rate_and_scale():
    m = tmask.dropout_scale_mask((64, 1024), 0, tmask.site_salt(1, 0, 0), 0.5)
    keep = m > 0
    assert abs(keep.float().mean().item() - 0.5) < 0.02
    assert torch.all(m[keep] == 2.0)
