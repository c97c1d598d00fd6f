"""Batched image transforms on the device, [B, H, W, C] float tensors.

Counterpart of ``rau_vqa_tpu/ops/transforms.py``: the reference's per-image
transform library (utils/transforms.lua, the fb.resnet.torch set) as
functions over a batch, random crops and flips per example.  The loader only
ever used Compose + ColorNormalize (vqa_prepro_loader.lua:60-62); the rest is
the full surface, for parity and for preprocessing on the card.

Randomness.  ``jax.random``'s bits cannot be matched, so each random
transform takes an explicit ``torch.Generator`` on the image's device and is
split in two: a draw (``*_draw``: crop origins, flip flags, angles, alphas,
the jitter's order, the sized crop's candidates) and an apply (``*_at``)
that takes the drawn tensors.  The public function is the draw followed by
the apply; the tests feed the JAX package's own draws into the applies.

Arithmetic follows the JAX package op for op in float32.  Two traps: a
division whose divisor is a Python number (on the card) or whose dividend is
one (``2.0 / t``, everywhere) multiplies by a reciprocal and misses the
quotient by an ulp, so such divisions here divide two tensors (``_div``);
and ``torch.round`` rounds half to even, as ``jnp.round`` does, while the
reference's crop dims round half up (``_torch_round``).
"""

from __future__ import annotations

import itertools
import math
from typing import Callable

import torch
import torch.nn.functional as F

Transform = Callable[..., torch.Tensor]

# ImageNet statistics (fb.resnet.torch; vqa_prepro_loader.lua:56-59)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# Caffe-VGG BGR means (vqa_prepro_loader.lua:55)
VGG_MEAN_BGR = (103.939, 116.779, 123.68)
# PCA lighting basis (fb.resnet.torch)
LIGHTING_ALPHASTD = 0.1
LIGHTING_EIGVAL = (0.2175, 0.0188, 0.0045)
LIGHTING_EIGVEC = (
    (-0.5675, 0.7192, 0.4009),
    (-0.5808, -0.0045, -0.8140),
    (-0.5836, -0.6948, 0.4203),
)
# color_jitter's six orders of (brightness, contrast, saturation)
JITTER_ORDERS = tuple(itertools.permutations(range(3)))


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a float32 tensor on ``like``'s device (a Python number
    rounds to float32 first, as JAX's weak scalars do)."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def _div(a, b) -> torch.Tensor:
    """a / b, correctly rounded: both operands tensors on one device."""
    like = a if torch.is_tensor(a) else b
    return torch.div(_f32(a, like), _f32(b, like))


def compose(*transforms: Transform) -> Transform:
    """transforms.lua:17 Compose: applies in list order.  With a generator,
    each transform takes it in turn (its draws advance it), where the JAX
    package folds the key with the transform's index."""
    def apply(img, gen=None):
        for t in transforms:
            img = t(img) if gen is None else t(img, gen)
        return img
    return apply


def color_normalize(img: torch.Tensor, mean=IMAGENET_MEAN,
                    std=IMAGENET_STD) -> torch.Tensor:
    """(x - mean) / std per channel (transforms.lua:26-35)."""
    mean = torch.as_tensor(mean, dtype=img.dtype, device=img.device)
    std = torch.as_tensor(std, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def vgg_preprocess(img: torch.Tensor) -> torch.Tensor:
    """RGB [0, 1] -> BGR * 255 - mean_bgr (vqa_prepro_loader.lua:1061-1064)."""
    bgr = img.flip(-1) * 255.0
    return bgr - torch.as_tensor(VGG_MEAN_BGR, dtype=img.dtype, device=img.device)


# ---------------------------------------------------------------------------
# resizing: jax.image.resize's separable weight matrices
# ---------------------------------------------------------------------------

def _keys_cubic(x):
    """Keys' cubic kernel, a = -0.5 (jax._src.image.scale)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}
_METHODS = {"linear": "linear", "bilinear": "linear", "trilinear": "linear",
            "triangle": "linear", "cubic": "cubic", "bicubic": "cubic",
            "tricubic": "cubic"}


def _weight_mat(n_in: int, n_out: int, kernel, antialias: bool, device) -> torch.Tensor:
    """[n_in, n_out] resampling weights, as jax.image.scale_and_translate
    builds them (``compute_weight_mat``, translation 0): sample at
    (out + 0.5) * in / out - 0.5, the step rounded once from double; with
    ``antialias`` the kernel widened by in / out when shrinking; each
    output's weights normalised by their sum
    (zero where that sum is under 1000 float32 eps); zero for a sample
    outside [-0.5, in - 0.5]."""
    one = torch.ones((), device=device)
    inv_scale = torch.tensor(1.0 / (n_out / n_in), device=device)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs()
    if antialias:
        x = _div(x, torch.clamp(inv_scale, min=1.0))
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    _div(w, torch.where(total != 0, total, one)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(img: torch.Tensor, h: int, w: int, method: str, antialias: bool) -> torch.Tensor:
    """jax.image.resize over H and W of [B, H, W, C], its triangle or Keys
    cubic kernel; an axis whose size stays is left as it is (the kernels
    interpolate)."""
    if method not in _METHODS:
        raise ValueError(f"unknown resize method {method!r}; one of {sorted(_METHODS)}")
    kernel = _KERNELS[_METHODS[method]]
    img = img if img.is_floating_point() else img.float()
    B, H, W, C = img.shape
    if h != H:
        img = torch.einsum("bhwc,hk->bkwc", img,
                           _weight_mat(H, h, kernel, antialias, img.device).to(img.dtype))
    if w != W:
        img = torch.einsum("bhwc,wk->bhkc", img,
                           _weight_mat(W, w, kernel, antialias, img.device).to(img.dtype))
    return img


def scale_shorter_side(img: torch.Tensor, size: int, method: str = "cubic") -> torch.Tensor:
    """Resize so that the shorter side is ``size`` (transforms.lua:38-52),
    both sides by size / min(H, W), the other rounded by Python's ``round``.
    No antialiasing, as the reference's ``image.scale``: jax.image.resize's
    Keys cubic, which differs from ``_cubic_sample``'s edge-replicated
    Catmull-Rom at the border and from ``F.interpolate``'s a = -0.75."""
    B, H, W, C = img.shape
    if H <= W:
        new_h, new_w = size, max(1, round(W * size / H))
    else:
        new_h, new_w = max(1, round(H * size / W)), size
    return _resize(img, new_h, new_w, method, antialias=False)


def resize(img: torch.Tensor, h: int, w: int, method: str = "bilinear") -> torch.Tensor:
    """jax.image.resize to [B, h, w, C], antialiased when shrinking (its
    default)."""
    return _resize(img, h, w, method, antialias=True)


# ---------------------------------------------------------------------------
# crops and flips
# ---------------------------------------------------------------------------

def center_crop(img: torch.Tensor, size: int) -> torch.Tensor:
    """transforms.lua:54-61."""
    B, H, W, C = img.shape
    y0, x0 = (H - size) // 2, (W - size) // 2
    return img[:, y0:y0 + size, x0:x0 + size, :]


def _dynamic_crop(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                  size: int) -> torch.Tensor:
    """A size x size window a example at (y0, x0); an origin is clamped so
    that the window fits, as ``lax.dynamic_slice`` clamps it."""
    B, H, W, C = img.shape
    y0 = y0.long().clamp(0, H - size)
    x0 = x0.long().clamp(0, W - size)
    i = torch.arange(size, device=img.device)
    b = torch.arange(B, device=img.device)[:, None, None]
    return img[b, (y0[:, None] + i)[:, :, None], (x0[:, None] + i)[:, None, :]]


def random_crop_draw(img: torch.Tensor, gen: torch.Generator, size: int,
                     padding: int = 0):
    """(y0, x0) [B] int64: origins uniform over the padded image's
    positions that fit the window."""
    B, H, W, _ = img.shape
    H, W = H + 2 * padding, W + 2 * padding
    y0 = torch.randint(0, H - size + 1, (B,), generator=gen, device=img.device)
    x0 = torch.randint(0, W - size + 1, (B,), generator=gen, device=img.device)
    return y0, x0


def random_crop_at(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, size: int,
                   padding: int = 0) -> torch.Tensor:
    """The window at the drawn origins of the image zero-padded by
    ``padding`` on each side (transforms.lua:63-87)."""
    if padding > 0:
        img = F.pad(img, (0, 0, padding, padding, padding, padding))
    return _dynamic_crop(img, y0, x0, size)


def random_crop(img: torch.Tensor, gen: torch.Generator, size: int,
                padding: int = 0) -> torch.Tensor:
    """A random square crop a example (transforms.lua:63-87)."""
    return random_crop_at(img, *random_crop_draw(img, gen, size, padding), size, padding)


def horizontal_flip_draw(img: torch.Tensor, gen: torch.Generator, prob: float = 0.5):
    """flip [B] bool: each example flipped with probability ``prob``."""
    return torch.rand(img.shape[0], generator=gen, device=img.device) < prob


def horizontal_flip_at(img: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(flip[:, None, None, None], img.flip(2), img)


def horizontal_flip(img: torch.Tensor, gen: torch.Generator,
                    prob: float = 0.5) -> torch.Tensor:
    """A random flip a example (transforms.lua:166-173)."""
    return horizontal_flip_at(img, horizontal_flip_draw(img, gen, prob))


def ten_crop(img: torch.Tensor, size: int) -> torch.Tensor:
    """Centre and four corners, then their mirrors: [10, B, size, size, C]
    (transforms.lua:89-112)."""
    B, H, W, C = img.shape
    corners = [((H - size) // 2, (W - size) // 2), (0, 0), (0, W - size),
               (H - size, 0), (H - size, W - size)]
    crops = [img[:, y:y + size, x:x + size, :] for y, x in corners]
    crops += [c.flip(2) for c in crops]
    return torch.stack(crops)


# ---------------------------------------------------------------------------
# samplers and the scale-and-crop transforms
# ---------------------------------------------------------------------------

def _bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """img [B, H, W, C] sampled bilinearly on the grid ys [B, S] x xs [B, S]
    (pixel-centre coordinates, clamped to the image) -> [B, S, S, C]."""
    B, H, W, C = img.shape
    ys = ys.clamp(0.0, H - 1.0)
    xs = xs.clamp(0.0, W - 1.0)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    y0, x0 = y0.long(), x0.long()
    y1, x1 = (y0 + 1).clamp(max=H - 1), (x0 + 1).clamp(max=W - 1)
    b = torch.arange(B, device=img.device)[:, None, None]

    def g(yy, xx):
        return img[b, yy[:, :, None], xx[:, None, :]]

    top = g(y0, x0) * (1 - wx) + g(y0, x1) * wx
    bot = g(y1, x0) * (1 - wx) + g(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _catmull_rom_weights(t: torch.Tensor):
    """Catmull-Rom (a = -0.5) weights of the taps at -1, 0, 1, 2 around a
    sample with fractional part ``t``: the kernel torch's ``image.scale``
    'bicubic' evaluates, which the reference pins (transforms.lua:39, 127,
    158)."""
    t2 = t * t
    t3 = t2 * t
    return (0.5 * (-t + 2.0 * t2 - t3),
            0.5 * (2.0 - 5.0 * t2 + 3.0 * t3),
            0.5 * (t + 4.0 * t2 - 3.0 * t3),
            0.5 * (-t2 + t3))


def _cubic_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Separable Catmull-Rom sampling on the grid ys [B, S] x xs [B, S],
    taps replicated at the edge (torch image's policy, on purpose unlike
    ``resize``) -> [B, S, S, C]."""
    B, H, W, C = img.shape
    ys = ys.clamp(0.0, H - 1.0)
    xs = xs.clamp(0.0, W - 1.0)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy = _catmull_rom_weights((ys - y0)[:, :, None, None])
    wx = _catmull_rom_weights((xs - x0)[:, None, :, None])
    y0, x0 = y0.long(), x0.long()
    b = torch.arange(B, device=img.device)[:, None, None]
    xtaps = [(x0 + (i - 1)).clamp(0, W - 1)[:, None, :] for i in range(4)]
    out = torch.zeros((B, ys.shape[1], xs.shape[1], C), dtype=img.dtype, device=img.device)
    for j in range(4):
        yy = (y0 + (j - 1)).clamp(0, H - 1)[:, :, None]
        row = torch.zeros_like(out)
        for i in range(4):
            row = row + img[b, yy, xtaps[i]] * wx[i]
        out = out + row * wy[j]
    return out


def _torch_round(x: torch.Tensor) -> torch.Tensor:
    """floor(x + 0.5): torch7's round, half away from zero for x > 0.
    ``torch.round`` is half to even and would move a crop dim by one on an
    exact .5 (common for rational aspects such as 3:2)."""
    return torch.floor(x + 0.5)


def _randint_at(u: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """Integers in [0, upper] inclusive from uniforms ``u`` in [0, 1), a
    bound an element: torch.random(0, n) of the reference's crop origins
    (transforms.lua:80, 153-154).  Float32, integer-valued."""
    return torch.minimum(torch.floor(u * (upper + 1.0)), upper)


def _randint_traced(gen: torch.Generator, shape, upper: torch.Tensor) -> torch.Tensor:
    """``_randint_at`` on fresh uniforms."""
    return _randint_at(torch.rand(shape, generator=gen, device=upper.device), upper)


def random_scale(img: torch.Tensor, gen: torch.Generator, minsize: int,
                 maxsize: int) -> torch.Tensor:
    """RandomScale (transforms.lua:114-129) approximated in static shapes,
    as in the JAX package: the max scale, then a random crop of the min
    size.  ``random_scale_crop`` is the exact form of RandomScale followed
    by a fixed-size crop."""
    scaled = scale_shorter_side(img, maxsize)
    if maxsize <= minsize:
        return scaled
    return random_crop(scaled, gen, int(minsize))


def _virtual_dims(H: int, W: int, target: torch.Tensor):
    """(th, tw): the image's dims scaled so that its shorter side is
    ``target`` (transforms.lua:119-124), the other rounded half up."""
    if W < H:
        return _torch_round(_f32(H / W, target) * target), target
    return target, _torch_round(_f32(W / H, target) * target)


def random_scale_crop_draw(img: torch.Tensor, gen: torch.Generator, minsize: int,
                           maxsize: int, size: int):
    """(target, y0, x0) [B] float32, integer-valued: the shorter side's
    target uniform over the integers [minsize, maxsize] (:118), and the crop
    origin uniform over [0, virtual - size] inclusive (:80)."""
    B, H, W, _ = img.shape
    target = torch.randint(minsize, maxsize + 1, (B,), generator=gen,
                           device=img.device).float()
    th, tw = _virtual_dims(H, W, target)
    return target, _randint_traced(gen, (B,), th - size), _randint_traced(gen, (B,), tw - size)


def random_scale_crop_at(img: torch.Tensor, target: torch.Tensor, y0: torch.Tensor,
                         x0: torch.Tensor, size: int) -> torch.Tensor:
    """The size x size window at (y0, x0) of the image scaled to shorter
    side ``target``, sampled straight from the source by one Catmull-Rom
    gather at src = (dst + 0.5) * SRC / DST - 0.5."""
    B, H, W, C = img.shape
    th, tw = _virtual_dims(H, W, target.float())
    i = torch.arange(size, dtype=torch.float32, device=img.device)
    ys = (y0.float()[:, None] + i[None, :] + 0.5) * _div(H, th)[:, None] - 0.5
    xs = (x0.float()[:, None] + i[None, :] + 0.5) * _div(W, tw)[:, None] - 0.5
    return _cubic_sample(img, ys, xs)


def random_scale_crop(img: torch.Tensor, gen: torch.Generator, minsize: int, maxsize: int,
                      size: int) -> torch.Tensor:
    """RandomScale(minsize, maxsize) then RandomCrop(size) (transforms.lua:
    114-129, 63-87), exact in static shapes.  Needs minsize >= size, as the
    reference composition does."""
    if minsize < size:
        raise ValueError(f"minsize {minsize} < crop size {size}: the "
                         f"reference composition would crash too")
    return random_scale_crop_at(img, *random_scale_crop_draw(img, gen, minsize, maxsize, size),
                                size)


def _sized_crop_candidates(H: int, W: int, area, aspect, swap, uy, ux):
    """The candidate windows (h, w, y1, x1) [B, A], float32 integer-valued,
    from the draws: ``area`` the fraction of the image's area, ``aspect``
    w / h, ``swap`` trades w and h, ``uy``/``ux`` uniforms of the origin
    over [0, H - h] x [0, W - w] inclusive (clamped at 0 where the window
    does not fit; such a candidate is never chosen)."""
    area = area * _f32(H * W, area)
    w = _torch_round(torch.sqrt(area * aspect))
    h = _torch_round(torch.sqrt(_div(area, aspect)))
    w, h = torch.where(swap, h, w), torch.where(swap, w, h)
    y1 = _randint_at(uy, torch.clamp(H - h, min=0.0))
    x1 = _randint_at(ux, torch.clamp(W - w, min=0.0))
    return h, w, y1, x1


def random_sized_crop_draw(img: torch.Tensor, gen: torch.Generator, *,
                           min_area: float = 0.08, attempts: int = 10):
    """(h, w, y1, x1) [B, attempts]: the reference's rejection loop's draws
    (transforms.lua:137-154), all at once: area uniform in [min_area, 1] of
    the image's, aspect uniform in [3/4, 4/3], a 50% swap of w and h, dims
    rounded half up, integer origins over the inclusive range."""
    B, H, W, _ = img.shape
    shape, dev = (B, int(attempts)), img.device

    def u():
        return torch.rand(shape, generator=gen, device=dev)

    area = u() * (1.0 - min_area) + min_area
    aspect = u() * (4 / 3 - 3 / 4) + 3 / 4
    swap = u() < 0.5
    return _sized_crop_candidates(H, W, area, aspect, swap, u(), u())


def random_sized_crop_at(img: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                         y1: torch.Tensor, x1: torch.Tensor, size: int) -> torch.Tensor:
    """The first candidate that fits wins, chosen by a mask (no branch on
    the data); where none fits, Scale(size) + CenterCrop(size) (:162-163)
    with the origin from ceil.  The crop and its bicubic resize to ``size``
    (:158) are one Catmull-Rom gather on the half-pixel grid."""
    B, H, W, C = img.shape
    valid = (h <= H) & (w <= W)
    first = valid.int().argmax(1)[:, None]
    has_valid = valid.any(1)

    def pick(v):
        return v.gather(1, first)[:, 0]

    ch, cw, cy, cx = pick(h), pick(w), pick(y1), pick(x1)
    if H <= W:
        vh, vw = float(size), float(max(1, round(W * size / H)))
    else:
        vh, vw = float(max(1, round(H * size / W))), float(size)
    fy = math.ceil((vh - size) / 2) * (H / vh)
    fx = math.ceil((vw - size) / 2) * (W / vw)
    y0 = torch.where(has_valid, cy, _f32(fy, cy))
    x0 = torch.where(has_valid, cx, _f32(fx, cx))
    sy = torch.where(has_valid, _div(ch, size), _f32(H / vh, ch))
    sx = torch.where(has_valid, _div(cw, size), _f32(W / vw, cw))
    i = torch.arange(size, dtype=torch.float32, device=img.device)
    ys = y0[:, None] + (i[None, :] + 0.5) * sy[:, None] - 0.5
    xs = x0[:, None] + (i[None, :] + 0.5) * sx[:, None] - 0.5
    return _cubic_sample(img, ys, xs)


def random_sized_crop(img: torch.Tensor, gen: torch.Generator, size: int, *,
                      min_area: float = 0.08, attempts: int = 10) -> torch.Tensor:
    """Inception-style random area and aspect crop resized to ``size``
    (transforms.lua:131-164), exact in static shapes."""
    cands = random_sized_crop_draw(img, gen, min_area=min_area, attempts=attempts)
    return random_sized_crop_at(img, *cands, size)


def rotation_draw(img: torch.Tensor, gen: torch.Generator, deg: float):
    """theta [B]: an angle in degrees uniform in [-deg, deg] a example."""
    u = torch.rand(img.shape[0], generator=gen, device=img.device)
    return u * (2 * deg) - deg


def rotation_at(img: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotation by ``theta`` degrees about ((H - 1) / 2, (W - 1) / 2),
    bilinear, a tap outside the image counting 0: JAX's
    ``map_coordinates(order=1, mode='constant')`` written out, its four
    taps summed in its order."""
    B, H, W, C = img.shape
    th = theta.float() * _f32(math.pi / 180.0, img)
    cos, sin = torch.cos(th)[:, None, None], torch.sin(th)[:, None, None]
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=img.device),
                            torch.arange(W, dtype=torch.float32, device=img.device),
                            indexing="ij")
    sy = cos * (yy - cy) - sin * (xx - cx) + cy
    sx = sin * (yy - cy) + cos * (xx - cx) + cx
    b = torch.arange(B, device=img.device)[:, None, None]

    def taps(c, size):
        lower = torch.floor(c)
        upper_w = c - lower
        i = lower.long()
        return [(i, 1 - upper_w), (i + 1, upper_w)]

    out = None
    for (iy, wy), (ix, wx) in itertools.product(taps(sy, H), taps(sx, W)):
        valid = ((iy >= 0) & (iy < H) & (ix >= 0) & (ix < W))[..., None]
        v = img[b, iy.clamp(0, H - 1), ix.clamp(0, W - 1)]
        term = (wy * wx)[..., None] * torch.where(valid, v, torch.zeros_like(v))
        out = term if out is None else out + term
    return out


def rotation(img: torch.Tensor, gen: torch.Generator, deg: float) -> torch.Tensor:
    """A random rotation in [-deg, deg] degrees a example
    (transforms.lua:175-183)."""
    return rotation_at(img, rotation_draw(img, gen, deg))


# ---------------------------------------------------------------------------
# photometric transforms
# ---------------------------------------------------------------------------

def _grayscale(img: torch.Tensor) -> torch.Tensor:
    """Luma by the fb.resnet.torch weights (transforms.lua:205-216),
    broadcast over the channels."""
    w = torch.as_tensor((0.299, 0.587, 0.114), dtype=img.dtype, device=img.device)
    return (img * w).sum(-1, keepdim=True).expand(img.shape)


def _blend(a: torch.Tensor, b: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    alpha = alpha.reshape(alpha.shape + (1,) * (a.dim() - alpha.dim()))
    return alpha * a + (1.0 - alpha) * b


def _alpha_draw(img: torch.Tensor, gen: torch.Generator, var: float) -> torch.Tensor:
    """alpha [B] = 1 + U(-var, var)."""
    u = torch.rand(img.shape[0], generator=gen, device=img.device)
    return 1.0 + (u * (2 * var) - var)


def saturation_at(img: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return _blend(img, _grayscale(img), alpha)


def brightness_at(img: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return _blend(img, torch.zeros_like(img), alpha)


def contrast_at(img: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    gray_mean = _grayscale(img).mean(dim=(1, 2), keepdim=True)
    return _blend(img, gray_mean.expand(img.shape), alpha)


def saturation(img: torch.Tensor, gen: torch.Generator, var: float) -> torch.Tensor:
    """blend(img, gray(img), 1 + U(-var, var)) (transforms.lua:219-233)."""
    return saturation_at(img, _alpha_draw(img, gen, var))


def brightness(img: torch.Tensor, gen: torch.Generator, var: float) -> torch.Tensor:
    """blend(img, 0, 1 + U(-var, var)) (transforms.lua:236-249)."""
    return brightness_at(img, _alpha_draw(img, gen, var))


def contrast(img: torch.Tensor, gen: torch.Generator, var: float) -> torch.Tensor:
    """blend(img, mean(gray(img)) over H and W, 1 + U(-var, var))
    (transforms.lua:252-266)."""
    return contrast_at(img, _alpha_draw(img, gen, var))


def lighting_draw(img: torch.Tensor, gen: torch.Generator,
                  alphastd: float = LIGHTING_ALPHASTD) -> torch.Tensor:
    """alpha [B, 3]: N(0, alphastd) a principal component."""
    return torch.randn((img.shape[0], 3), generator=gen, device=img.device) * alphastd


def lighting_at(img: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    eigval = torch.as_tensor(LIGHTING_EIGVAL, dtype=img.dtype, device=img.device)
    eigvec = torch.as_tensor(LIGHTING_EIGVEC, dtype=img.dtype, device=img.device)
    shift = (eigvec * alpha[:, None, :] * eigval[None, None, :]).sum(-1)
    return img + shift[:, None, None, :]


def lighting(img: torch.Tensor, gen: torch.Generator,
             alphastd: float = LIGHTING_ALPHASTD) -> torch.Tensor:
    """AlexNet's PCA colour noise (transforms.lua:185-203)."""
    return lighting_at(img, lighting_draw(img, gen, alphastd))


def color_jitter_draw(img: torch.Tensor, gen: torch.Generator, *, brightness_var=0.4,
                      contrast_var=0.4, saturation_var=0.4):
    """(order, alphas): one of the six orders for the whole batch (as
    ``lax.switch`` picks one), an index into ``JITTER_ORDERS``, and alphas
    [3, B] of brightness, contrast and saturation, drawn in the order's
    slots."""
    order = int(torch.randint(0, len(JITTER_ORDERS), (), generator=gen, device=img.device))
    var = (brightness_var, contrast_var, saturation_var)
    alphas = [None] * 3
    for t in JITTER_ORDERS[order]:
        alphas[t] = _alpha_draw(img, gen, var[t])
    return order, torch.stack(alphas)


def color_jitter_at(img: torch.Tensor, order: int, alphas: torch.Tensor) -> torch.Tensor:
    apply = (brightness_at, contrast_at, saturation_at)
    for t in JITTER_ORDERS[order]:
        img = apply[t](img, alphas[t])
    return img


def color_jitter(img: torch.Tensor, gen: torch.Generator, *, brightness_var=0.4,
                 contrast_var=0.4, saturation_var=0.4) -> torch.Tensor:
    """Brightness, contrast and saturation in a random order
    (transforms.lua:268-291), one order a batch."""
    order, alphas = color_jitter_draw(img, gen, brightness_var=brightness_var,
                                      contrast_var=contrast_var,
                                      saturation_var=saturation_var)
    return color_jitter_at(img, order, alphas)
