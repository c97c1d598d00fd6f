"""A run of ResNet identity bottlenecks: a CUDA kernel and its plain version.

Counterpart of ``rau_vqa_tpu/ops/fused_resnet.py``.  ``fused_identity_stage``
runs N stacked identity blocks (stride 1, no downsample) over an NHWC
activation: for a CUDA tensor through ``csrc/fused_resnet.cu`` (one launch of
the C entry point, one grid per block, with y1 and y2 kept in shared
memory), for a CPU tensor through ``fused_identity_stage_reference``.  The
weights come as the JAX package's stacked ``[N, ...]`` tree
(``stack_identity_blocks``); the bf16 kernel reads K-major copies of them
(``pack_stage_weights``).  ``stage_plan`` chooses the kernel's CTA tile and
ring depth for a shape, and reckons its shared memory and the weight bytes
its CTAs read from L2.  ``KERNEL.launches`` counts one per stage call.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from rau_vqa_tpu_torch.ops._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("fused_resnet", "fused_identity_stage_launch",
                [_P] * 9 + [_I] * 11 + [_P])

_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")
_KMAJOR = ("w1t", "w2t", "w3t")

# the bf16 kernel's constants (csrc/fused_resnet.cu)
SK = 64                 # K rows a weight slab: one 128-byte swizzle row of bf16
NB3 = 128               # the expand's columns a slab
SMEM_LIMIT = 232_448    # the opt-in shared memory of a Hopper block
# (TH, TW, NB, ring depth) the kernel is instantiated for (the launcher's
# STAGE_TILES list; the card tests hold the two to each other through
# ``launcher_smem``); NB is the reduce's and the 3x3's column chunk
INSTANCES = ((4, 28, 64, 3), (4, 28, 128, 3), (4, 28, 128, 4), (4, 14, 64, 3), (4, 14, 128, 3))
# tiles in order of preference where two execute the same rows
TILES = ((4, 28), (4, 14))


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def tile_rows(th: int, tw: int) -> Tuple[int, int]:
    """(halo-grid rows of a tile, the m64 rows the 3x3 and the expand run):
    the kernel computes the 3x3 on rows r = py (tw + 2) + px of the halo
    grid, the two columns past tw of each tile row included."""
    mrows = th * (tw + 2)
    return mrows, 128 if mrows > 64 else 64


def smem_bytes(th: int, tw: int, nb: int, ring: int, C: int, Cw: int) -> int:
    """A CTA's dynamic shared memory (``Layout`` in csrc/fused_resnet.cu):
    the weight ring, the x ring or y2 (which alias), y1 (with the rows the
    3x3's last tap reads past the halo), the biases, the barriers and 1 KB
    to align the base."""
    hw = tw + 2
    nhalo = (th + 2) * hw
    _, m = tile_rows(th, tw)
    chunks = Cw // SK
    xslot = _ceil(nhalo * 128, 1024) * 1024
    wslot = max(nb, NB3) * 128
    xy = _ceil(max(ring * xslot, chunks * m * 128), 1024) * 1024
    yrows = _ceil(max(nhalo, m + 2 * hw + 2), 8) * 8
    return (ring * wslot + xy + chunks * yrows * 128 + _ceil((2 * Cw + C) * 2, 16) * 16
            + 16 * ring + 1024)


def launcher_smem(th: int, tw: int, nb: int, ring: int, C: int, Cw: int) -> int:
    """The shared memory the built launcher asks for this instantiation at
    (C, Cw), or -1 where the library has no such instantiation; builds the
    library (card only).  ``smem_bytes`` and ``INSTANCES`` must agree with
    it."""
    return KERNEL.query("fused_identity_stage_smem", th, tw, nb, ring, C, Cw)


def block_weight_bytes(C: int, Cw: int) -> int:
    """The bf16 weight bytes of one identity block (w1, w2, w3)."""
    return 2 * (2 * C * Cw + 9 * Cw * Cw)


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """How the kernel's grid covers one identity block: CTA tiles of
    ``th`` x ``tw`` pixels of one image, the reduce's and the 3x3's column
    chunk ``nb``, a ``ring``-deep slab ring; ``ctas`` CTAs
    (``tiles_h * tiles_w * B``), ``smem`` bytes of shared memory a CTA (one
    CTA a SM), and ``weight_bytes`` the L2 -> SM weight bytes a block reads
    (each CTA reads each weight once)."""
    th: int
    tw: int
    nb: int
    ring: int
    tiles_h: int
    tiles_w: int
    ctas: int
    smem: int
    weight_bytes: int

    @property
    def tiles(self) -> int:
        return self.tiles_h * self.tiles_w

    def cta_tile(self, cta: int) -> Tuple[int, int, int]:
        """(image, first row, first column) of CTA ``cta``'s output tile."""
        tile, img = cta % self.tiles, cta // self.tiles
        return img, (tile // self.tiles_w) * self.th, (tile % self.tiles_w) * self.tw


def stage_plan(B: int, H: int, W: int, C: int, Cw: int, n_sm: int, *,
               tile: Optional[Tuple[int, int]] = None,
               ring: Optional[int] = None) -> StagePlan:
    """The bf16 kernel's plan for x [B, H, W, C] with bottleneck width Cw on
    a card of ``n_sm`` SMs.  The tile is the one of ``TILES`` (or ``tile``)
    that fits shared memory and executes the fewest rows (tiles x
    ``tile_rows``), with the deepest ring instantiated for it that fits (or
    ``ring``).  Raises ``ValueError`` for a shape or a choice the kernel
    does not take."""
    if C % 128 or Cw % 64 or not 64 <= Cw <= 512:
        raise ValueError(f"fused_identity_stage: the kernel takes C % 128 == 0 and Cw in "
                         f"64..512, a multiple of 64; got C={C}, Cw={Cw}")
    if min(B, H, W) < 1 or n_sm < 1:
        raise ValueError(f"fused_identity_stage: needs B, H, W, n_sm >= 1, got "
                         f"{B}, {H}, {W}, {n_sm}")
    nb = 128 if Cw % 128 == 0 else 64
    best = None
    for th, tw in ([tuple(tile)] if tile else TILES):
        # the deepest ring instantiated for this tile that fits
        depths = [ring] if ring else sorted(
            (r for t, w, c, r in INSTANCES if (t, w, c) == (th, tw, nb)), reverse=True)
        if tile and not depths:
            raise ValueError(f"fused_identity_stage: no kernel for a {th}x{tw} tile")
        for depth in depths:
            if (th, tw, nb, depth) not in INSTANCES:
                if tile:
                    raise ValueError(f"fused_identity_stage: no kernel for a {th}x{tw} tile "
                                     f"with {nb}-column chunks and a {depth}-deep ring")
                continue
            smem = smem_bytes(th, tw, nb, depth, C, Cw)
            if smem <= SMEM_LIMIT:
                break
        else:
            continue
        tiles_h, tiles_w = _ceil(H, th), _ceil(W, tw)
        rows = tiles_h * tiles_w * tile_rows(th, tw)[1]
        if best is None or rows < best[0]:
            best = (rows, th, tw, depth, tiles_h, tiles_w, smem)
    if best is None:
        with_ring = f" with a {ring}-deep ring" if ring else ""
        raise ValueError(f"fused_identity_stage: no instantiated tile{with_ring} fits "
                         f"Cw={Cw} in {SMEM_LIMIT} bytes of shared memory")
    _, th, tw, ring, tiles_h, tiles_w, smem = best
    ctas = tiles_h * tiles_w * B
    return StagePlan(th=th, tw=tw, nb=nb, ring=ring, tiles_h=tiles_h, tiles_w=tiles_w,
                     ctas=ctas, smem=smem, weight_bytes=ctas * block_weight_bytes(C, Cw))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pack_stage_weights(stack: Dict) -> Dict:
    """K-major bf16 copies of a stack's weights for the kernel's TMA slabs:
    w1t [N, Cw, C], w2t [N, 9 Cw, Cw] (row t Cw + o holds tap t's column o),
    w3t [N, C, Cw].  Made once per parameter set (``resnet._stage_stack``
    keeps them beside the stack)."""
    N, C, Cw = stack["w1"].shape
    return {"w1t": stack["w1"].transpose(1, 2).contiguous(),
            "w2t": stack["w2"].transpose(2, 3).reshape(N, 9 * Cw, Cw).contiguous(),
            "w3t": stack["w3"].transpose(1, 2).contiguous()}


def stack_identity_blocks(blocks: List[Dict]) -> Dict:
    """Stack a run of folded identity-block trees (no ``down``) into the
    ``[N, ...]`` tree the stage runs over: w1 [N, C, Cw], b1 [N, 1, Cw],
    w2 [N, 9, Cw, Cw] (tap t = 3 dy + dx), b2 [N, 1, Cw], w3 [N, Cw, C],
    b3 [N, 1, C]."""
    assert blocks and all("down" not in b for b in blocks)

    def stack(conv, key, lead):
        # HWIO [kh, kw, ci, co] -> [kh*kw, ci, co] (lead = (9,)) or [ci, co];
        # a bias [co] -> [1, co]
        return torch.stack([b[conv][key].reshape(*lead, *b[conv][key].shape[-2:])
                            if key == "w" else b[conv][key].reshape(1, -1)
                            for b in blocks]).contiguous()

    return {"w1": stack("conv1", "w", ()), "b1": stack("conv1", "b", ()),
            "w2": stack("conv2", "w", (9,)), "b2": stack("conv2", "b", ()),
            "w3": stack("conv3", "w", ()), "b3": stack("conv3", "b", ())}


def pick_block_b(batch: int, want: int) -> int:
    """Largest divisor of ``batch`` that is <= want (>= 1)."""
    b = max(1, min(want, batch))
    while batch % b:
        b -= 1
    return b


def fused_identity_stage_reference(x: torch.Tensor, stack: Dict) -> torch.Tensor:
    """Plain version, float32 torch ops: y1 and y2 and each block's output
    round to ``x.dtype`` where ``_stage_kernel`` rounds them
    (``rau_vqa_tpu/ops/fused_resnet.py:93-95``, ``:113``, ``:119``,
    ``:123-124``); products see operands of that type and sum in float32."""
    dt = x.dtype
    B, H, W, C = x.shape
    N, _, Cw = stack["w1"].shape

    def rnd(v):
        return v.to(dt).float()

    h = x.float()
    for n in range(N):
        w1, b1, w2, b2, w3, b3 = (stack[k][n].float() for k in _KEYS)
        y1 = rnd(torch.relu(h @ w1 + b1[0]))
        # the 3x3 pads y1 with zeros (the JAX plane is zeroed, :79)
        y1p = F.pad(y1, (0, 0, 1, 1, 1, 1))
        acc = b2[0].expand(B, H, W, Cw)
        for t in range(9):
            dy, dx = divmod(t, 3)
            acc = acc + y1p[:, dy:dy + H, dx:dx + W, :] @ w2[t]
        y2 = rnd(torch.relu(acc))
        h = rnd(torch.relu((h + y2 @ w3) + b3[0]))
    return h.to(dt)


def fused_identity_stage(x: torch.Tensor, stack: Dict, *, block_b: int = 2,
                         plan: Optional[StagePlan] = None,
                         kernel: Kernel = KERNEL) -> torch.Tensor:
    """Run the N stacked identity blocks of ``stack`` over x [B, H, W, C].

    A CUDA ``x`` launches the kernel (or raises), in bf16 with ``plan`` or
    ``stage_plan``'s for this shape and card, reading the stack's K-major
    copies (``pack_stage_weights``; made here if the stack lacks them); a
    CPU ``x`` runs ``fused_identity_stage_reference``.  ``block_b`` is the
    JAX wrapper's batch tile; it must divide B, as there, and is otherwise
    unused: the CUDA kernel tiles each image's pixels its own way.
    ``kernel`` is ``KERNEL`` or a probe build of the same launcher
    (``bench_torch_stage.py``)."""
    B, H, W, C = x.shape
    if B % block_b:
        raise ValueError(f"batch {B} not divisible by block_b {block_b}")
    if x.device.type == "cpu":
        return fused_identity_stage_reference(x, stack)
    if x.device.type != "cuda":
        raise ValueError(f"fused_identity_stage: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        raise ValueError("fused_identity_stage: x must be contiguous bf16 or float32 NHWC")
    N, _, Cw = stack["w1"].shape
    if C % 128 or Cw % 64 or not 64 <= Cw <= 512:
        raise ValueError(f"fused_identity_stage: the kernel takes C % 128 == 0 and Cw in "
                         f"64..512, a multiple of 64; got C={C}, Cw={Cw}")
    want = {"w1": (N, C, Cw), "b1": (N, 1, Cw), "w2": (N, 9, Cw, Cw),
            "b2": (N, 1, Cw), "w3": (N, Cw, C), "b3": (N, 1, C)}
    for k, shape in want.items():
        w = stack[k]
        if (w.dtype != x.dtype or tuple(w.shape) != shape or not w.is_contiguous()
                or w.device != x.device):
            raise ValueError(f"fused_identity_stage: {k} must be contiguous {x.dtype} "
                             f"{shape} on {x.device}")
    weights = [stack[k] for k in _KEYS]
    knobs = (0,) * 4
    if x.dtype == torch.bfloat16:
        kmaj = stack if all(k in stack for k in _KMAJOR) else pack_stage_weights(stack)
        want_t = {"w1t": (N, Cw, C), "w2t": (N, 9 * Cw, Cw), "w3t": (N, C, Cw)}
        for k, shape in want_t.items():
            w = kmaj[k]
            if (w.dtype != x.dtype or tuple(w.shape) != shape or not w.is_contiguous()
                    or w.device != x.device):
                raise ValueError(f"fused_identity_stage: {k} must be contiguous {x.dtype} "
                                 f"{shape} on {x.device}; pack_stage_weights makes it")
        weights[0], weights[2], weights[4] = (kmaj[k] for k in _KMAJOR)
        plan = plan or stage_plan(B, H, W, C, Cw, _sm_count(x.device.index or 0))
        knobs = (plan.th, plan.tw, plan.nb, plan.ring)
    out = torch.empty_like(x)
    scratch = torch.empty_like(x) if N > 1 else out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    kernel.launch(x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                  *(w.data_ptr() for w in weights),
                  B, H, W, C, Cw, N, int(x.dtype == torch.bfloat16), *knobs, stream)
    return out
