"""The eval hop loop: a CUDA kernel and its plain version.

Counterpart of ``rau_vqa_tpu/ops/rau_hops.py``.  ``rau_hops`` runs all nHop
answering units through one C entry of ``csrc/rau_hops.cu`` for CUDA
tensors, and ``rau_hops_reference`` (the ``_hop_body`` math in plain
PyTorch) for CPU tensors.  The entry enqueues each hop as batch-wide phases
(``hops_plan``): tile GEMMs on the bf16 ``mma.sync`` body of
``csrc/tile_gemm.cuh`` for the ``[B, *]`` products, a row kernel for the
score, softmax and pooling, and the training forward's cell kernel.  The
image embeddings ``ifeat`` / ``iatt`` are computed outside, as in the JAX
package.  The kernel takes its weights in bf16, cast once by
``pack_hop_weights``.  The wrapper reaches the kernel and the plain version
through the custom op ``rau_vqa::rau_hops`` (a CPU and a CUDA implementation
and a shape function), so that ``torch.export`` keeps the call in an exported
graph.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

from rau_vqa_tpu_torch.config import ModelConfig
from rau_vqa_tpu_torch.convert import map_tree
from rau_vqa_tpu_torch.ops._build import Kernel
from rau_vqa_tpu_torch.ops.lstm_encoder import dot
from rau_vqa_tpu_torch.ops.rau_train_hops import (
    EW_THREADS,
    ROWS_SMEM_LIMIT,
    Phase,
    _cdiv,
    _describe,
    _phase_makers,
)
from rau_vqa_tpu_torch.ops.treeflat import mult_shapes, pluck, rebuild

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("rau_hops", "rau_hops_launch",
                [_P, _P, _P, ctypes.POINTER(_P), _P, _P, _P, _P] + [_I] * 8
                + [ctypes.c_longlong, _P])

# the kernel's weight order, as rau_vqa_tpu/ops/rau_hops.py _WEIGHT_ORDER
WEIGHT_ORDER: Sequence[Tuple] = (
    ("q_proj", "w"), ("q_proj", "b"), ("h_proj", "w"), ("h_proj", "b"),
    ("att_q", "w"), ("att_q", "b"), ("att_score", "w"), ("att_score", "b"),
    ("att_mem", "w"), ("att_mem", "b"),
    ("attprob_proj", "w"), ("attprob_proj", "b"),
    ("attlstm", "layers", 0, "wi"), ("attlstm", "layers", 0, "bi"),
    ("attlstm", "layers", 0, "wh"), ("attlstm", "layers", 0, "bh"),
    ("merge", "w"), ("merge", "b"), ("cls", "w"), ("cls", "b"),
    ("do_pred", "w"), ("do_pred", "b"),
)


# the groups of the ``mult`` tree that the hop loop reads
_GROUPS = tuple(dict.fromkeys(path[0] for path in WEIGHT_ORDER))


def pack_hop_weights(mp: Dict) -> Dict:
    """The hop loop's weights in bf16, contiguous, in the ``mult`` tree's
    layout (the Pallas wrapper casts the same tensors per call)."""
    return map_tree(lambda w: w.to(torch.bfloat16).contiguous(),
                    {k: mp[k] for k in _GROUPS})


def _hop_body(mp, q, ifeat, iatt, c, h, dot_dtype):
    """One answering-unit hop (``_hop_body``, rau_hops.py:39-80)."""
    def d(x, w):
        return dot(x, w, dot_dtype)

    qfeat = torch.tanh(d(q, mp["q_proj"]["w"]) + mp["q_proj"]["b"]
                       + d(h, mp["h_proj"]["w"]) + mp["h_proj"]["b"])
    qatt = d(qfeat, mp["att_q"]["w"]) + mp["att_q"]["b"]            # [B, F]
    addfeat = torch.tanh(iatt + qatt[:, None, :])                    # [B, S, F]
    B, S, F = addfeat.shape
    score_c = d(addfeat.reshape(B * S, F), mp["att_score"]["w"]).reshape(B, S)
    attscore = (score_c + mp["att_score"]["b"][0]
                + d(h, mp["att_mem"]["w"]) + mp["att_mem"]["b"])
    attprob = torch.softmax(attscore, dim=-1)                        # [B, S]
    attfeat = torch.sum(ifeat * attprob[:, :, None], dim=1)
    join = (qfeat + attfeat
            + d(attprob, mp["attprob_proj"]["w"]) + mp["attprob_proj"]["b"])
    lp = mp["attlstm"]["layers"][0]
    R = c.shape[-1]
    gates = d(join, lp["wi"]) + lp["bi"] + d(h, lp["wh"]) + lp["bh"]
    i_g = torch.sigmoid(gates[:, :R])
    g_t = torch.tanh(gates[:, R:2 * R])
    f_g = torch.sigmoid(gates[:, 2 * R:3 * R])
    o_g = torch.sigmoid(gates[:, 3 * R:])
    c = f_g * c + i_g * g_t
    h = o_g * torch.tanh(c)
    merge = join + d(h, mp["merge"]["w"]) + mp["merge"]["b"]
    score = d(merge, mp["cls"]["w"]) + mp["cls"]["b"]
    do_pred = torch.sigmoid(d(merge, mp["do_pred"]["w"])[:, 0]
                            + mp["do_pred"]["b"][0])
    return score, do_pred, attprob, c, h


def rau_hops_reference(mp: Dict, cfg: ModelConfig, q: torch.Tensor,
                       ifeat: torch.Tensor, iatt: torch.Tensor, *,
                       dot_dtype: torch.dtype = torch.float32):
    """Plain hop loop on precomputed image embeddings (eval mode):
    q [B, Q], ifeat [B, S, M], iatt [B, S, F] -> (scores [H, B, A],
    do_pred [H, B], attprob [H, B, S]), all float32."""
    mp = map_tree(lambda w: w.float(), {k: mp[k] for k in _GROUPS})
    q, ifeat, iatt = q.float(), ifeat.float(), iatt.float()
    B = q.shape[0]
    c = q.new_zeros(B, cfg.att_state_dim)
    h = q.new_zeros(B, cfg.att_state_dim)
    scores, do_preds, attprobs = [], [], []
    for _ in range(cfg.n_hops):
        s, d, a, c, h = _hop_body(mp, q, ifeat, iatt, c, h, dot_dtype)
        scores.append(s)
        do_preds.append(d)
        attprobs.append(a)
    return torch.stack(scores), torch.stack(do_preds), torch.stack(attprobs)


# ---------------------------------------------------------------------------
# The kernel's plan
# ---------------------------------------------------------------------------

ROWS_EVAL_THREADS = EW_THREADS   # threads a CTA of the row kernel (the launcher's RT)


def _pool_slices(M: int) -> int:
    """The slices of S in the row kernel's pooling: each thread takes 8
    columns of one slice; as many slices as the threads fill."""
    groups = M // 8
    return 1 if groups >= ROWS_EVAL_THREADS else ROWS_EVAL_THREADS // groups


def rows_eval_smem(S: int, M: int, F: int) -> int:
    """The row kernel's dynamic shared memory in bytes: qatt and w_score
    [F], the probabilities [S] and the pooling's partials [slices, M]."""
    return 4 * (2 * F + S + _pool_slices(M) * M)


@dataclass(frozen=True)
class HopsPlan:
    """The kernel's launches for one batch: ``setup``, enqueued once a call
    (prep: the carry zeroed and q cast to bf16; the question projection),
    then ``hop``, the phases every hop enqueues, in the C entry's order.
    ``phases`` is what a dry run of one hop makes.  The scratch buffer is
    the launcher's to size (``hops_launcher_plan``), which also reports the
    grids and shared memory that the card's checks hold these phases to."""
    setup: Tuple[Phase, ...]
    hop: Tuple[Phase, ...]

    @property
    def phases(self) -> Tuple[Phase, ...]:
        return self.setup + self.hop

    def kernels(self, n_hops: int) -> int:
        """The device kernels a call of ``n_hops`` hops runs."""
        return len(self.setup) + n_hops * len(self.hop)


def _widths(cfg: ModelConfig) -> Dict[str, int]:
    return dict(Q=cfg.rnnout_dim, S=cfg.cnn_spat, M=cfg.multfeat_dim, F=cfg.attfeat_dim,
                R=cfg.att_rnn_size, A=cfg.answer_size, H=cfg.n_hops)


def hops_plan(B: int, cfg: ModelConfig) -> HopsPlan:
    """The phases and tiles of the kernel at batch ``B`` and ``cfg``'s
    widths: every product a tile GEMM on the bf16 ``mma.sync`` body's small
    tile (``GEMM_TILES[bfloat16]["small"]``), the row kernel one CTA a row.
    Raises ``ValueError`` for shapes the kernel does not take: a width below
    1, an ATTLSTM of more than one layer (the Pallas kernel's limit too),
    ``attfeat_dim`` or ``multfeat_dim`` not a multiple of 8 (the row
    kernel's 16-byte loads), a row kernel beyond ROWS_SMEM_LIMIT, or
    offsets past 32 bits."""
    w = _widths(cfg)
    Q, S, M, F, R, A = (w[k] for k in "QSMFRA")
    bad = [k for k, v in dict(B=B, **w).items() if v < 1]
    if bad:
        raise ValueError(f"rau_hops: {bad} must be at least 1")
    if cfg.att_rnn_layers != 1:
        raise ValueError("rau_hops: the kernel runs a 1-layer ATTLSTM, as the "
                         "Pallas kernel does")
    if F % 8 or M % 8:
        raise ValueError(f"rau_hops: attfeat_dim {F} and multfeat_dim {M} must be "
                         f"multiples of 8")
    smem = rows_eval_smem(S, M, F)
    if smem > ROWS_SMEM_LIMIT:
        raise ValueError(f"rau_hops: the row kernel needs {smem} bytes of shared "
                         f"memory, at most {ROWS_SMEM_LIMIT}")
    if B * S * max(M, F) >= 2 ** 31 or B * max(Q, 4 * R, A) >= 2 ** 31:
        raise ValueError(f"rau_hops: batch {B} too large for 32-bit offsets")
    gemm, other = _phase_makers(torch.bfloat16)
    ew = EW_THREADS
    setup = (
        other("prep", (min(_cdiv(B * Q + B * R, ew), 4096), 1, 1)),
        gemm("q Wq", B, M, Q, "small"),
    )
    hop = (
        gemm("h Wmem", B, S, R, "small"),
        gemm("qfeat", B, M, R, "small"),
        gemm("qatt", B, F, M, "small"),
        other("rows_eval", (B, 1, 1), smem),
        gemm("join", B, M, S, "small"),
        gemm("join Wli", B, 4 * R, M, "small"),
        gemm("gates", B, 4 * R, R, "small"),
        other("cell", (_cdiv(B * R, ew), 1, 1)),
        gemm("merge", B, M, R, "small"),
        gemm("classifier", B, A, M, "small"),
        gemm("do_pred", B, 1, M, "small"),
    )
    return HopsPlan(setup, hop)


@functools.lru_cache(maxsize=64)
def hops_launcher_plan(B: int, Q: int, S: int, M: int, F: int, R: int, A: int):
    """The built launcher's own account of a one-hop call at these shapes
    (``rau_hops_describe``, a dry run of its entry): (the scratch floats it
    carves, -1 where it cannot run them; each launch's (grid x, y, z,
    dynamic shared memory bytes), in the order it enqueues them)."""
    return _describe(KERNEL, "rau_hops_describe", (B, Q, S, M, F, R, A))


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def rau_hops(hw: Dict, cfg: ModelConfig, q: torch.Tensor, ifeat: torch.Tensor,
             iatt: torch.Tensor):
    """The hop loop, through the ``rau_vqa::rau_hops`` op.  ``hw`` comes from
    ``pack_hop_weights``; ``ifeat`` and ``iatt`` are bf16, as the Pallas
    wrapper casts them.

    CUDA tensors launch the kernel (or raises); CPU tensors run
    ``rau_hops_reference`` with bf16 dots, the kernel's arithmetic."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rau_hops: unsupported device {q.device}")
    if cfg.att_rnn_layers != 1:
        raise ValueError("rau_hops: the kernel runs a 1-layer ATTLSTM, as the "
                         "Pallas kernel does")
    return torch.ops.rau_vqa.rau_hops(q, ifeat, iatt,
                                      [pluck(hw, path) for path in WEIGHT_ORDER],
                                      cfg.n_hops)


@dataclass(frozen=True)
class _Widths:
    """The widths ``hops_plan`` and ``mult_shapes`` read, from the op's
    operands (the op takes tensors and ints, not a ModelConfig)."""
    rnnout_dim: int
    cnn_spat: int
    cnn_dim: int
    multfeat_dim: int
    attfeat_dim: int
    att_rnn_size: int
    answer_size: int
    n_hops: int
    att_rnn_layers: int = 1

    @property
    def att_state_dim(self) -> int:
        return self.att_rnn_size


def _widths_of(q, ifeat, iatt, weights, n_hops) -> _Widths:
    w = dict(zip(WEIGHT_ORDER, weights))
    return _Widths(rnnout_dim=q.shape[1], cnn_spat=ifeat.shape[1], cnn_dim=0,
                   multfeat_dim=ifeat.shape[2], attfeat_dim=iatt.shape[2],
                   att_rnn_size=w[("attlstm", "layers", 0, "wh")].shape[0],
                   answer_size=w[("cls", "w")].shape[1], n_hops=n_hops)


@torch.library.custom_op("rau_vqa::rau_hops", mutates_args=(), device_types="cpu")
def _rau_hops_op(q: torch.Tensor, ifeat: torch.Tensor, iatt: torch.Tensor,
                 weights: List[torch.Tensor], n_hops: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op on the CPU: ``rau_hops_reference`` with bf16 dots.  ``weights``
    in ``WEIGHT_ORDER``."""
    return rau_hops_reference(rebuild(WEIGHT_ORDER, weights),
                              _widths_of(q, ifeat, iatt, weights, n_hops), q, ifeat,
                              iatt, dot_dtype=torch.bfloat16)


@_rau_hops_op.register_fake
def _(q, ifeat, iatt, weights, n_hops):
    B, S = ifeat.shape[0], ifeat.shape[1]
    A = weights[WEIGHT_ORDER.index(("cls", "w"))].shape[1]
    f32 = torch.float32
    return (q.new_empty(n_hops, B, A, dtype=f32), q.new_empty(n_hops, B, dtype=f32),
            q.new_empty(n_hops, B, S, dtype=f32))


@_rau_hops_op.register_kernel("cuda")
def _rau_hops_cuda(q, ifeat, iatt, weights, n_hops):
    """The op on the card: one call of the C entry on the current stream."""
    cfg = _widths_of(q, ifeat, iatt, weights, n_hops)
    B = q.shape[0]
    hops_plan(B, cfg)
    w = _widths(cfg)
    scratch_floats, _ = hops_launcher_plan(B, *(w[k] for k in "QSMFRA"))
    if scratch_floats < 0:
        raise ValueError(f"rau_hops: the launcher cannot run batch {B} at these widths")
    return _launch(rebuild(WEIGHT_ORDER, weights), cfg, q, ifeat, iatt, scratch_floats)


def _launch(hw: Dict, cfg, q: torch.Tensor, ifeat: torch.Tensor,
            iatt: torch.Tensor, scratch_floats: int):
    """The kernel on CUDA tensors with this much scratch; raises where the
    launcher refuses it."""
    w = _widths(cfg)
    B = q.shape[0]
    Q, S, M, F, R, A, H = (w[k] for k in "QSMFRAH")
    checks = [("q", q, torch.float32, (B, Q)),
              ("ifeat", ifeat, torch.bfloat16, (B, S, M)),
              ("iatt", iatt, torch.bfloat16, (B, S, F))]
    shapes = mult_shapes(cfg)
    weights = [pluck(hw, path) for path in WEIGHT_ORDER]
    checks += [("/".join(map(str, path)), wt, torch.bfloat16, shapes[path])
               for path, wt in zip(WEIGHT_ORDER, weights)]
    for name, t, dtype, shape in checks:
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"rau_hops: {name} must be contiguous {dtype} "
                             f"{shape} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    dev = q.device
    scratch = torch.empty(max(scratch_floats, 0), device=dev, dtype=torch.float32)
    scores = torch.empty(H, B, A, device=dev, dtype=torch.float32)
    do_pred = torch.empty(H, B, device=dev, dtype=torch.float32)
    attprob = torch.empty(H, B, S, device=dev, dtype=torch.float32)
    ptrs = (_P * len(weights))(*[wt.data_ptr() for wt in weights])
    stream = torch.cuda.current_stream(dev).cuda_stream
    KERNEL.launch(q.data_ptr(), ifeat.data_ptr(), iatt.data_ptr(), ptrs,
                  scratch.data_ptr(), scores.data_ptr(), do_pred.data_ptr(),
                  attprob.data_ptr(), B, Q, S, M, F, R, A, H, scratch_floats, stream)
    return scores, do_pred, attprob
