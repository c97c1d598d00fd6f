"""The serving step's image embedding: a CUDA kernel and its plain version.

``embed_image`` computes ``ifeat = tanh(feats W_i + b_i)`` and ``iatt =
ifeat W_a + b_a`` (``models.rau.embed_image`` at eval) and returns both in
bf16, the types the hop loop reads.  For CUDA tensors it launches
``csrc/embed_image.cu``: float32 products on the tensor cores in 3xTF32
(each operand split into a tf32 big part and a tf32 small part, three
products summed in float32), the bias, the tanh and the casts fused, in two
launches of one kernel from one C entry (``KERNEL.launches`` counts one a
call).  For CPU tensors it runs ``embed_image_reference``: the same PyTorch
operations as ``models.rau.embed_image`` plus the two casts, bit for bit.

The weights' big and small planes are made once per parameter set by
``pack_embed_weights`` (``eval.predict.pack_kernel_weights``), for weights on
the card; the features are split in the kernel.  ``embed_plan`` picks each
phase's tile from the row count.  The kernel takes every row count and the
widths ``check_widths`` allows (those ``rau_hops`` takes); a CUDA call with
other widths, or operands that are not float32, contiguous and 16-byte
aligned, raises ``ValueError``.  The wrapper reaches both versions through
the custom op ``rau_vqa::embed_image``, so that ``torch.export`` keeps the
call in an exported graph.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from rau_vqa_tpu_torch.ops._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("embed_image", "embed_image_launch", [_P] * 8 + [_I] * 9 + [_P])

SK = 32                                         # K a ring slot (csrc/embed_image.cu)
# the launcher's tiles (BM rows, BN columns), largest first
EMBED_TILES: Tuple[Tuple[int, int], ...] = ((128, 128), (64, 128), (64, 64))
TF32_PEAK = 495e12                              # H100 SXM, dense TF32 FLOP/s


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to tf32 as ``cvt.rna.tf32.f32`` does: to 10
    mantissa bits, ties away from zero, the low 13 bits zero."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) = (tf32(x), tf32(x - big)): the two parts of a float32
    operand in 3xTF32, as the kernel splits the features."""
    big = tf32_round(x)
    return big, tf32_round(x.to(torch.float32) - big)


def split_planes(w: torch.Tensor) -> torch.Tensor:
    """A weight ``[K, N]`` as the kernel's B operand: its big and small parts,
    K-major, stacked ``[2 N, K]`` (big rows first)."""
    big, small = tf32_split(w.detach().t())
    return torch.cat([big, small]).contiguous()


def pack_embed_weights(mp: Dict) -> Dict:
    """The kernel's weights for the ``mult`` tree: ``wi`` [2 M, Dc] and
    ``wa`` [2 F, M], the planes of ``i_embed.w`` and ``att_i.w``; empty for
    weights off the card, where the plain version runs."""
    if mp["i_embed"]["w"].device.type != "cuda":
        return {}
    return {"wi": split_planes(mp["i_embed"]["w"]), "wa": split_planes(mp["att_i"]["w"])}


def embed_image_reference(feats, w_i, b_i, w_a, b_a) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``models.rau.embed_image``'s operations at eval,
    then the casts to bf16 (``predict_fused``'s before the kernel)."""
    ifeat = torch.tanh(feats @ w_i + b_i)
    iatt = ifeat @ w_a + b_a
    return ifeat.to(torch.bfloat16).contiguous(), iatt.to(torch.bfloat16).contiguous()


def check_widths(rows: int, Dc: int, M: int, F: int) -> None:
    """Raises ``ValueError`` for widths the kernel does not take: fewer than
    one row, ``Dc`` not a multiple of 4 (TMA's 16-byte row pitch), ``M`` or
    ``F`` not a multiple of 8 (``rau_hops``'s rule; the epilogue stores
    8-column groups whole), or rows past 32 bits.  Row and column tails are
    masked, K tails read as zeros."""
    if rows < 1 or Dc < 1 or M < 1 or F < 1:
        raise ValueError(f"embed_image: rows {rows}, Dc {Dc}, M {M} and F {F} must be at "
                         f"least 1")
    if Dc % 4:
        raise ValueError(f"embed_image: cnn_dim {Dc} must be a multiple of 4")
    if M % 8 or F % 8:
        raise ValueError(f"embed_image: multfeat_dim {M} and attfeat_dim {F} must be "
                         f"multiples of 8")
    if rows >= 2 ** 31:
        raise ValueError(f"embed_image: {rows} rows too many for 32-bit row indices")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tile(rows: int, N: int, n_sm: int) -> Tuple[int, int]:
    """The largest tile of ``EMBED_TILES`` no wider than ``N`` (the
    narrowest for ``N`` < 64) whose tiles fill the ``n_sm`` SMs once; the
    smallest where none does."""
    fits = [t for t in EMBED_TILES if t[1] <= N] or [EMBED_TILES[-1]]
    for bm, bn in fits:
        if _cdiv(rows, bm) * _cdiv(N, bn) >= n_sm:
            return bm, bn
    return fits[-1]


@dataclass(frozen=True)
class EmbedPlan:
    """The two launches' tiles (BM, BN): ``ifeat`` [rows, M] and ``iatt``
    [rows, F]."""
    ifeat: Tuple[int, int]
    iatt: Tuple[int, int]


@functools.lru_cache(maxsize=64)
def embed_plan(rows: int, M: int, F: int, n_sm: int) -> EmbedPlan:
    """Each phase's tile from the row count: 128 x 128 where its tiles fill
    the SMs, else 64 x 128, else 64 x 64 (the latency case of a few
    questions, where more CTAs share the work)."""
    return EmbedPlan(_tile(rows, M, n_sm), _tile(rows, F, n_sm))


def bound_s(rows: int, Dc: int, M: int, F: int) -> float:
    """The least time of the kernel on an H100: the two products' float32
    operations three times over (3xTF32) at the TF32 peak; its features,
    at 3.35 TB/s, take less at every width used."""
    return 3 * 2 * rows * (Dc * M + M * F) / TF32_PEAK


@functools.lru_cache(maxsize=8)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def embed_image(mp: Dict, ew: Dict, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ifeat [.., M], iatt [.., F]) in bf16, contiguous, for float32 feats
    [.., Dc], through the ``rau_vqa::embed_image`` op; ``ew`` from
    ``pack_embed_weights(mp)``.  CUDA tensors launch the kernel, CPU tensors
    run ``embed_image_reference``."""
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"embed_image: unsupported device {feats.device}")
    if feats.device.type == "cuda" and not ew:
        raise ValueError("embed_image: no weight planes: pack the weights on the card")
    none = ew or {"wi": _NO_PLANES, "wa": _NO_PLANES}
    return torch.ops.rau_vqa.embed_image(feats, mp["i_embed"]["w"], mp["i_embed"]["b"],
                                         mp["att_i"]["w"], mp["att_i"]["b"], none["wi"],
                                         none["wa"])


# the planes' place in a CPU call, which does not read them
_NO_PLANES = torch.empty(0)


# The op is defined through ``torch.library.Library``, not ``custom_op``:
# its dispatch costs the host ~13 us a call where ``custom_op``'s costs ~31
# (on an x86 host CPU), and at a few questions a call the host's enqueue is
# the step's time.
_LIB = torch.library.Library("rau_vqa", "FRAGMENT")
_LIB.define("embed_image(Tensor feats, Tensor w_i, Tensor b_i, Tensor w_a, Tensor b_a, "
            "Tensor wi_planes, Tensor wa_planes) -> (Tensor, Tensor)")


def _embed_image_cpu(feats, w_i, b_i, w_a, b_a, wi_planes, wa_planes):
    """The op on the CPU: the plain version (the planes unused)."""
    return embed_image_reference(feats, w_i, b_i, w_a, b_a)


@torch.library.register_fake("rau_vqa::embed_image", lib=_LIB)
def _(feats, w_i, b_i, w_a, b_a, wi_planes, wa_planes):
    lead = tuple(feats.shape[:-1])
    bf16 = torch.bfloat16
    return (feats.new_empty(lead + (w_i.shape[1],), dtype=bf16),
            feats.new_empty(lead + (w_a.shape[1],), dtype=bf16))


def check_operands(feats, w_i, b_i, w_a, b_a, wi_planes, wa_planes) -> int:
    """The kernel's row count; raises ``ValueError`` for widths it does not
    take (``check_widths``) or operands that are not float32, contiguous,
    16-byte aligned and on the features' device, or planes not of these
    weights' shapes."""
    if w_i.dim() != 2 or w_a.dim() != 2 or w_a.shape[0] != w_i.shape[1] \
            or feats.dim() < 1 or feats.shape[-1] != w_i.shape[0]:
        raise ValueError(f"embed_image: feats {tuple(feats.shape)}, W_i {tuple(w_i.shape)} "
                         f"and W_a {tuple(w_a.shape)} do not chain")
    Dc, M = w_i.shape
    F = w_a.shape[1]
    rows = feats.numel() // Dc if Dc else 0
    check_widths(rows, Dc, M, F)
    for name, t, shape in (("feats", feats, tuple(feats.shape)), ("W_i", w_i, (Dc, M)),
                           ("W_a", w_a, (M, F)), ("b_i", b_i, (M,)), ("b_a", b_a, (F,)),
                           ("W_i's planes", wi_planes, (2 * M, Dc)),
                           ("W_a's planes", wa_planes, (2 * F, M))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != feats.device or t.data_ptr() % 16):
            raise ValueError(f"embed_image: {name} must be contiguous, 16-byte aligned "
                             f"float32 {shape} on {feats.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return rows


def _embed_image_cuda(feats, w_i, b_i, w_a, b_a, wi_planes, wa_planes):
    """The op on the card: one call of the C entry on the current stream."""
    rows = check_operands(feats, w_i, b_i, w_a, b_a, wi_planes, wa_planes)
    Dc, M = w_i.shape
    F = w_a.shape[1]
    dev = feats.device
    lead = tuple(feats.shape[:-1])
    n_sm = _n_sm(dev.index if dev.index is not None else torch.cuda.current_device())
    plan = embed_plan(rows, M, F, n_sm)
    ifeat = torch.empty(lead + (M,), device=dev, dtype=torch.bfloat16)
    iatt = torch.empty(lead + (F,), device=dev, dtype=torch.bfloat16)
    scratch = torch.empty(rows, M, device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    KERNEL.launch(feats.data_ptr(), wi_planes.data_ptr(), b_i.data_ptr(), wa_planes.data_ptr(),
                  b_a.data_ptr(), ifeat.data_ptr(), iatt.data_ptr(), scratch.data_ptr(),
                  rows, Dc, M, F, *plan.ifeat, *plan.iatt, n_sm, stream)
    return ifeat, iatt


_LIB.impl("embed_image", _embed_image_cpu, "CPU")
_LIB.impl("embed_image", _embed_image_cuda, "CUDA")
