"""The port's image transforms against the JAX package's, on the CPU.

Inputs are numpy arrays from fixed seeds, images of 64 px or less, B <= 4.
Crops, flips and ``ten_crop`` must be equal; resizing, the samplers,
``rotation`` and the photometric transforms are held at rtol 1e-5 / atol
1e-6 (JAX at ``matmul_precision=highest``, tests/conftest.py).  The random
transforms cannot match ``jax.random``'s bits: each test recomputes the JAX
function's draws from its key, feeds them to the port's ``*_at`` apply and
compares with the JAX function on that key.  The port's own draws are held
by their ranges and their structure.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rau_vqa_tpu.ops import transforms as JT
from rau_vqa_tpu_torch.ops import transforms as TT

CLOSE = dict(rtol=1e-5, atol=1e-6)


def imgs(B=2, H=32, W=48, C=3, seed=0):
    return np.random.RandomState(seed).rand(B, H, W, C).astype(np.float32)


def both(x):
    return jnp.asarray(x), torch.as_tensor(x)


def assert_close(got, want, **bar):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, **(bar or CLOSE))


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# resizing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,W,size", [(32, 48, 64), (48, 32, 20), (33, 17, 24), (24, 24, 24)])
def test_scale_shorter_side_matches_jax(H, W, size):
    """Up and down, either side shorter, an odd side rounded by Python's
    round, and a side that stays (its axis untouched)."""
    xj, xt = both(imgs(H=H, W=W, seed=H + W))
    want = JT.scale_shorter_side(xj, size)
    assert_close(TT.scale_shorter_side(xt, size), want)


@pytest.mark.parametrize("method", ["bilinear", "cubic"])
@pytest.mark.parametrize("h,w", [(20, 60), (50, 13)])
def test_resize_matches_jax(method, h, w):
    """jax.image.resize's default antialias when shrinking, none when
    growing, for each kernel."""
    xj, xt = both(imgs(H=31, W=40, seed=3))
    assert_close(TT.resize(xt, h, w, method), JT.resize(xj, h, w, method))


def test_cubic_resize_is_neither_interpolate_nor_the_sampler():
    """A x2 cubic upsample of a unit step at the last pixel: Keys' a = -0.5
    with JAX's edge normalisation overshoots to 1.0882, where the
    edge-replicated Catmull-Rom sampler gives 1.0 and F.interpolate's
    a = -0.75 gives 1.1055; the port is JAX's."""
    row = np.zeros((1, 1, 8, 1), np.float32)
    row[..., -1, :] = 1.0
    want = np.asarray(jax.image.resize(jnp.asarray(row), (1, 1, 16, 1), "cubic"))
    got = TT.resize(torch.as_tensor(row), 1, 16, "cubic").numpy()
    assert_close(got, want)
    assert got.max() == pytest.approx(1.0882, abs=1e-4)


@pytest.mark.parametrize("method", ["area", "lanczos3", "nearest"])
def test_resize_refuses_an_unknown_method(method):
    """The triangle and Keys cubic kernels only: no path uses another."""
    with pytest.raises(ValueError, match="unknown resize method"):
        TT.resize(torch.zeros(1, 4, 4, 3), 2, 2, method)


# ---------------------------------------------------------------------------
# crops and flips: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,W,size", [(40, 40, 32), (33, 47, 20)])
def test_center_and_ten_crop_equal_jax(H, W, size):
    xj, xt = both(imgs(3, H, W, seed=1))
    np.testing.assert_array_equal(TT.center_crop(xt, size).numpy(),
                                  np.asarray(JT.center_crop(xj, size)))
    got, want = TT.ten_crop(xt, size).numpy(), np.asarray(JT.ten_crop(xj, size))
    assert got.shape == (10, 3, size, size, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("padding", [0, 4])
def test_random_crop_on_jax_draws_equals_jax(padding):
    xj, xt = both(imgs(4, 40, 36, seed=2))
    key, size = jax.random.PRNGKey(7), 32
    ky, kx = jax.random.split(key)
    H, W = 40 + 2 * padding, 36 + 2 * padding
    y0 = np.asarray(jax.random.randint(ky, (4,), 0, H - size + 1))
    x0 = np.asarray(jax.random.randint(kx, (4,), 0, W - size + 1))
    want = np.asarray(JT.random_crop(xj, key, size, padding))
    got = TT.random_crop_at(xt, torch.as_tensor(y0), torch.as_tensor(x0), size, padding)
    np.testing.assert_array_equal(got.numpy(), want)


def test_horizontal_flip_on_jax_draws_equals_jax():
    xj, xt = both(imgs(4, 8, 10, seed=3))
    key = jax.random.PRNGKey(5)
    flip = np.asarray(jax.random.bernoulli(key, 0.5, (4,)))
    assert 0 < flip.sum() < 4
    np.testing.assert_array_equal(
        TT.horizontal_flip_at(xt, torch.as_tensor(flip)).numpy(),
        np.asarray(JT.horizontal_flip(xj, key)))


def test_random_crop_and_flip_draws():
    """Origins over the whole inclusive range, per example; flags per
    example; deterministic for a seed."""
    x = torch.as_tensor(imgs(4, 40, 36))
    ys, xs = [], []
    for s in range(50):
        y0, x0 = TT.random_crop_draw(x, gen(s), 32, padding=2)
        ys.append(y0)
        xs.append(x0)
    ys, xs = torch.cat(ys), torch.cat(xs)
    assert ys.min() == 0 and ys.max() == 44 - 32 and xs.min() == 0 and xs.max() == 40 - 32
    y0, x0 = TT.random_crop_draw(x, gen(1), 32)
    assert len(set(zip(y0.tolist(), x0.tolist()))) > 1
    torch.testing.assert_close(TT.random_crop(x, gen(3), 32), TT.random_crop(x, gen(3), 32))
    flips = torch.stack([TT.horizontal_flip_draw(x, gen(s)) for s in range(20)])
    assert flips.dtype == torch.bool and 0.3 < flips.float().mean() < 0.7
    assert (flips.any(0)).all() and (~flips.all(0)).all()
    f = TT.horizontal_flip(x, gen(0), prob=1.0)
    np.testing.assert_array_equal(f.numpy(), x.numpy()[:, :, ::-1, :])


# ---------------------------------------------------------------------------
# samplers and the scale-and-crop transforms
# ---------------------------------------------------------------------------

def test_samplers_match_jax():
    rs = np.random.RandomState(7)
    img = rs.rand(2, 19, 21, 3).astype(np.float32)
    ys = (rs.rand(2, 9) * 22 - 2).astype(np.float32)    # beyond the edges too
    xs = (rs.rand(2, 9) * 24 - 2).astype(np.float32)
    (ij, it), (yj, yt), (xj, xt) = both(img), both(ys), both(xs)
    assert_close(TT._bilinear_sample(it, yt, xt), JT._bilinear_sample(ij, yj, xj))
    assert_close(TT._cubic_sample(it, yt, xt), JT._cubic_sample(ij, yj, xj))
    t = np.linspace(0, 1, 11, dtype=np.float32)
    for got, want in zip(TT._catmull_rom_weights(torch.as_tensor(t)),
                         JT._catmull_rom_weights(jnp.asarray(t))):
        assert_close(got, want)


def test_rounding_helpers_match_jax():
    x = np.array([0.5, 1.5, 2.5, 2.4999, 3.5000002, 7.0], np.float32)
    np.testing.assert_array_equal(TT._torch_round(torch.as_tensor(x)).numpy(),
                                  np.asarray(JT._torch_round(jnp.asarray(x))))
    # half up, unlike torch.round's (and jnp.round's) half to even
    assert TT._torch_round(torch.tensor(2.5)).item() == 3.0
    assert torch.round(torch.tensor(2.5)).item() == 2.0
    key = jax.random.PRNGKey(4)
    upper = np.array([0, 1, 5, 17, 300], np.float32)
    want = np.asarray(JT._randint_traced(key, (5,), jnp.asarray(upper)))
    u = np.asarray(jax.random.uniform(key, (5,)))
    got = TT._randint_at(torch.as_tensor(u), torch.as_tensor(upper))
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)


def test_random_scale_on_jax_draws_equals_jax():
    xj, xt = both(imgs(3, 30, 40, seed=4))
    key, minsize, maxsize = jax.random.PRNGKey(2), 20, 28
    scaled = TT.scale_shorter_side(xt, maxsize)
    ky, kx = jax.random.split(key)
    y0 = jax.random.randint(ky, (3,), 0, scaled.shape[1] - minsize + 1)
    x0 = jax.random.randint(kx, (3,), 0, scaled.shape[2] - minsize + 1)
    got = TT.random_crop_at(scaled, torch.as_tensor(np.asarray(y0)),
                            torch.as_tensor(np.asarray(x0)), minsize)
    assert_close(got, JT.random_scale(xj, key, minsize, maxsize))
    # the port's random_scale is that composition on its own draws
    g1, g2 = gen(9), gen(9)
    y0, x0 = TT.random_crop_draw(scaled, g2, minsize)
    torch.testing.assert_close(TT.random_scale(xt, g1, minsize, maxsize),
                               TT.random_crop_at(scaled, y0, x0, minsize), rtol=0, atol=0)
    assert_close(TT.random_scale(xt, gen(0), 24, 24), JT.scale_shorter_side(xj, 24))


def jax_scale_crop_draws(key, B, H, W, minsize, maxsize, size):
    """random_scale_crop's draws, as the JAX function makes them."""
    k1, k2, k3 = jax.random.split(key, 3)
    target = jax.random.randint(k1, (B,), minsize, maxsize + 1).astype(jnp.float32)
    if W < H:
        tw, th = target, JT._torch_round(H / W * target)
    else:
        th, tw = target, JT._torch_round(W / H * target)
    y0 = JT._randint_traced(k2, (B,), th - size)
    x0 = JT._randint_traced(k3, (B,), tw - size)
    return [torch.as_tensor(np.asarray(v)) for v in (target, y0, x0)]


@pytest.mark.parametrize("H,W,lo,hi,size", [(40, 30, 20, 36, 18), (30, 45, 18, 30, 16),
                                            (32, 32, 16, 16, 16)])
def test_random_scale_crop_on_jax_draws_equals_jax(H, W, lo, hi, size):
    xj, xt = both(imgs(4, H, W, seed=5))
    key = jax.random.PRNGKey(H + lo)
    want = JT.random_scale_crop(xj, key, lo, hi, size)
    draws = jax_scale_crop_draws(key, 4, H, W, lo, hi, size)
    assert_close(TT.random_scale_crop_at(xt, *draws, size), want)
    with pytest.raises(ValueError, match="minsize"):
        TT.random_scale_crop(xt, gen(), size - 1, hi, size)


def test_random_scale_crop_draws():
    """Integer targets over [min, max] and integer origins over each
    example's inclusive range [0, virtual - size]."""
    x = torch.zeros(4, 40, 30, 3)
    lo, hi, size = 20, 36, 18
    targets, ranges = [], []
    for s in range(60):
        target, y0, x0 = TT.random_scale_crop_draw(x, gen(s), lo, hi, size)
        th, tw = TT._virtual_dims(40, 30, target)
        for v in (target, y0, x0):
            assert (v == v.round()).all()
        assert ((y0 >= 0) & (y0 <= th - size) & (x0 >= 0) & (x0 <= tw - size)).all()
        targets.append(target)
        ranges.append((y0 == th - size) | (x0 == tw - size))
    targets = torch.cat(targets)
    assert targets.min() == lo and targets.max() == hi
    assert torch.cat(ranges).any()                  # the inclusive bound is reached
    target, y0, _ = TT.random_scale_crop_draw(x, gen(0), lo, hi, size)
    assert len(set(target.tolist())) > 1 or len(set(y0.tolist())) > 1


def jax_sized_crop_uniforms(key, B, A, min_area=0.08):
    """random_sized_crop's uniforms, as the JAX function draws them."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    area = jax.random.uniform(k1, (B, A), minval=min_area, maxval=1.0)
    aspect = jax.random.uniform(k2, (B, A), minval=3 / 4, maxval=4 / 3)
    swap = jax.random.uniform(k3, (B, A)) < 0.5
    uy, ux = jax.random.uniform(k4, (B, A)), jax.random.uniform(k5, (B, A))
    return [torch.as_tensor(np.asarray(v)) for v in (area, aspect, swap, uy, ux)]


@pytest.mark.parametrize("H,W,size,attempts,seed", [
    (28, 24, 14, 10, 0), (20, 36, 16, 1, None)])
def test_random_sized_crop_on_jax_draws_equals_jax(H, W, size, attempts, seed):
    """The first fitting candidate (10 attempts), and the fallback: one
    attempt on a key whose candidate fits no example."""
    xj, xt = both(imgs(3, H, W, seed=11))
    if seed is None:
        for seed in range(200):
            u = jax_sized_crop_uniforms(jax.random.PRNGKey(seed), 3, attempts)
            h, w, _, _ = TT._sized_crop_candidates(H, W, *u)
            if not ((h <= H) & (w <= W)).any():
                break
    key = jax.random.PRNGKey(seed)
    cands = TT._sized_crop_candidates(H, W, *jax_sized_crop_uniforms(key, 3, attempts))
    want = JT.random_sized_crop(xj, key, size, attempts=attempts)
    assert_close(TT.random_sized_crop_at(xt, *cands, size), want)


def test_sized_crop_candidates_match_jax_rules():
    """Dims rounded half up, swapped, origins on the inclusive range: the
    JAX package's own test's oracle (tests/test_transforms_backbones.py:
    457-472) on the same uniforms."""
    H, W, B, A = 28, 24, 4, 10
    area, aspect, swap, uy, ux = (t.numpy() for t in
                                  jax_sized_crop_uniforms(jax.random.PRNGKey(3), B, A))
    a = area * np.float32(H * W)
    w = np.floor(np.sqrt(a * aspect) + np.float32(0.5))
    h = np.floor(np.sqrt(a / aspect) + np.float32(0.5))
    w, h = np.where(swap, h, w), np.where(swap, w, h)
    y1 = np.minimum(np.floor(uy * (np.maximum(H - h, 0) + 1)), np.maximum(H - h, 0))
    x1 = np.minimum(np.floor(ux * (np.maximum(W - w, 0) + 1)), np.maximum(W - w, 0))
    got = TT._sized_crop_candidates(H, W, *(torch.as_tensor(v) for v in
                                            (area, aspect, swap, uy, ux)))
    for g, want in zip(got, (h, w, y1, x1)):
        np.testing.assert_array_equal(g.numpy(), want)


def test_random_sized_crop_draws_first_fit_and_fallback():
    """The port's own draws: the first candidate that fits is the window
    (its sampling grid is the window's), and with none fitting the window
    is Scale + CenterCrop's."""
    H, W, size = 28, 24, 14
    x = torch.as_tensor(imgs(4, H, W, seed=6))
    h, w, y1, x1 = TT.random_sized_crop_draw(x, gen(2))
    assert h.shape == (4, 10)
    valid = (h <= H) & (w <= W)
    assert valid.any(1).all() and not valid.all()
    for v in (h, w, y1, x1):
        assert (v == v.round()).all()
    assert ((y1 >= 0) & (x1 >= 0)).all()
    assert ((y1 <= H - h) & (x1 <= W - w))[valid].all()
    got = TT.random_sized_crop_at(x, h, w, y1, x1, size)
    first = valid.int().argmax(1)
    i = torch.arange(size, dtype=torch.float32)
    for b in range(4):
        k = first[b]
        ys = (y1[b, k] + (i + 0.5) * (h[b, k] / size) - 0.5)[None]
        xs = (x1[b, k] + (i + 0.5) * (w[b, k] / size) - 0.5)[None]
        torch.testing.assert_close(got[b:b + 1], TT._cubic_sample(x[b:b + 1], ys, xs),
                                   rtol=1e-5, atol=1e-6)
    big = torch.full((4, 1), float(H + 1))
    got = TT.random_sized_crop_at(x, big, big, torch.zeros(4, 1), torch.zeros(4, 1), size)
    vw = round(W * size / H) if H <= W else size
    vh = size if H <= W else round(H * size / W)
    fy = math.ceil((vh - size) / 2) * (H / vh)
    fx = math.ceil((vw - size) / 2) * (W / vw)
    ys = (fy + (i + 0.5) * (H / vh) - 0.5).expand(4, size)
    xs = (fx + (i + 0.5) * (W / vw) - 0.5).expand(4, size)
    torch.testing.assert_close(got, TT._cubic_sample(x, ys, xs), rtol=1e-5, atol=1e-6)
    assert TT.random_sized_crop(x, gen(1), size).shape == (4, size, size, 3)


# ---------------------------------------------------------------------------
# rotation and the photometric transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,W", [(24, 24), (17, 30)])
def test_rotation_on_jax_draws_equals_jax(H, W):
    xj, xt = both(imgs(3, H, W, seed=8))
    key = jax.random.PRNGKey(H)
    theta = np.asarray(jax.random.uniform(key, (3,), minval=-30.0, maxval=30.0))
    want = JT.rotation(xj, key, 30.0)
    got = TT.rotation_at(xt, torch.as_tensor(theta))
    assert_close(got, want)
    assert (got.numpy() == 0).any()                 # corners left the image


def test_rotation_is_grid_sample_with_zeros():
    """The written-out gather is F.grid_sample's bilinear sampling with
    align_corners and zero padding, on the same coordinates."""
    x = torch.as_tensor(imgs(2, 20, 26, seed=9))
    theta = torch.tensor([12.0, -25.0])
    got = TT.rotation_at(x, theta)
    B, H, W, _ = x.shape
    th = theta * math.pi / 180
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    cy, cx = (H - 1) / 2, (W - 1) / 2
    c, s = th.cos()[:, None, None], th.sin()[:, None, None]
    sy = c * (yy - cy) - s * (xx - cx) + cy
    sx = s * (yy - cy) + c * (xx - cx) + cx
    grid = torch.stack([sx / (W - 1) * 2 - 1, sy / (H - 1) * 2 - 1], -1)
    want = torch.nn.functional.grid_sample(x.permute(0, 3, 1, 2), grid, mode="bilinear",
                                           padding_mode="zeros", align_corners=True)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=1e-5, atol=1e-5)
    theta = TT.rotation_draw(x, gen(0), 10.0)
    assert theta.shape == (2,) and theta.abs().max() <= 10.0 and theta[0] != theta[1]


def jax_alpha(key, B, var):
    return torch.as_tensor(np.asarray(1.0 + jax.random.uniform(key, (B,), minval=-var,
                                                               maxval=var)))


@pytest.mark.parametrize("name", ["saturation", "brightness", "contrast"])
def test_photometric_on_jax_draws_equal_jax(name):
    xj, xt = both(imgs(3, 16, 20, seed=10))
    key = jax.random.PRNGKey(3)
    want = getattr(JT, name)(xj, key, 0.4)
    assert_close(getattr(TT, name + "_at")(xt, jax_alpha(key, 3, 0.4)), want)
    assert_close(TT._grayscale(xt), JT._grayscale(xj))


def test_lighting_on_jax_draws_equals_jax():
    xj, xt = both(imgs(3, 16, 20, seed=12))
    key = jax.random.PRNGKey(6)
    alpha = torch.as_tensor(np.asarray(jax.random.normal(key, (3, 3)) * 0.1))
    assert_close(TT.lighting_at(xt, alpha), JT.lighting(xj, key))
    assert TT.LIGHTING_EIGVEC == JT.LIGHTING_EIGVEC and TT.LIGHTING_EIGVAL == JT.LIGHTING_EIGVAL
    a = TT.lighting_draw(xt, gen(1))
    assert a.shape == (3, 3) and 0.02 < a.std() < 0.3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_color_jitter_on_jax_draws_equals_jax(seed):
    xj, xt = both(imgs(3, 16, 20, seed=13))
    key = jax.random.PRNGKey(seed)
    k_pick, *keys = jax.random.split(key, 4)
    order = int(jax.random.randint(k_pick, (), 0, 6))
    var = (0.4, 0.3, 0.2)
    alphas = [None] * 3
    for slot, t in enumerate(TT.JITTER_ORDERS[order]):
        alphas[t] = jax_alpha(keys[slot], 3, var[t])
    want = JT.color_jitter(xj, key, brightness_var=0.4, contrast_var=0.3,
                           saturation_var=0.2)
    assert_close(TT.color_jitter_at(xt, order, torch.stack(alphas)), want)


def test_color_jitter_draws_one_order_a_batch():
    x = torch.zeros(4, 8, 8, 3)
    orders = set()
    for s in range(40):
        order, alphas = TT.color_jitter_draw(x, gen(s), brightness_var=0.4,
                                             contrast_var=0.2, saturation_var=0.1)
        assert isinstance(order, int) and alphas.shape == (3, 4)
        assert ((alphas - 1).abs() <= torch.tensor([0.4, 0.2, 0.1])[:, None]).all()
        orders.add(order)
    assert orders == set(range(6))
    # one order for the batch: a batch of one image repeated gets one result
    one = torch.as_tensor(imgs(1, 8, 8, seed=3)).expand(4, 8, 8, 3)
    order, alphas = TT.color_jitter_draw(one, gen(5))
    same = TT.color_jitter_at(one, order, alphas[:, :1].expand(3, 4))
    assert (same == same[:1]).all()
    torch.testing.assert_close(TT.color_jitter(one, gen(5)),
                               TT.color_jitter_at(one, order, alphas), rtol=0, atol=0)


def test_compose_applies_in_list_order():
    x = imgs(2, 40, 40, seed=14)
    xj, xt = both(x)
    plain_j = JT.compose(lambda im: im + 1.0, lambda im: im * 2.0, JT.color_normalize)
    plain_t = TT.compose(lambda im: im + 1.0, lambda im: im * 2.0, TT.color_normalize)
    assert_close(plain_t(xt), plain_j(xj))
    assert_close(plain_t(xt), TT.color_normalize((xt + 1.0) * 2.0))
    # with a generator each transform draws from it in turn
    pipe = TT.compose(lambda im, g: TT.random_crop(im, g, 32),
                      lambda im, g: TT.horizontal_flip(im, g),
                      lambda im, g: TT.color_normalize(im))
    g1, g2 = gen(4), gen(4)
    want = TT.color_normalize(TT.horizontal_flip(TT.random_crop(xt, g2, 32), g2))
    got = pipe(xt, g1)
    assert got.shape == (2, 32, 32, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
