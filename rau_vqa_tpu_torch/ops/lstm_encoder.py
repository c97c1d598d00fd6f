"""Question-encoder LSTM scan: a CUDA kernel and its plain version.

Counterpart of ``rau_vqa_tpu/ops/lstm_encoder.py``.  ``lstm_encode`` runs the
whole DeepLSTM over all tokens in one cooperative launch of
``csrc/lstm_encoder.cu`` for a CUDA tensor, and ``lstm_encode_reference``
(the same math in plain PyTorch) for a CPU tensor.  ``pack_encoder_weights``
makes, once per parameter set, the bf16 weights and the kernel's slabs: each
layer's stacked ``[wi; wh]`` laid out unit by unit, ``[R][4 gates][K]``, so
that the CTA owning units ``[u0, u0 + U)`` reads one contiguous block.
``lstm_plan`` chooses, from the batch and the card's SM count, how the grid
splits the units and rows (about one CTA per SM at every B) and how much
shared memory a CTA takes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from rau_vqa_tpu_torch.config import ModelConfig
from rau_vqa_tpu_torch.convert import map_tree
from rau_vqa_tpu_torch.models.rau import embed_question
from rau_vqa_tpu_torch.ops._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("lstm_encoder", "lstm_encode_launch",
                [_P] * 8 + [_I] * 10 + [_P])

# the kernel's constants (csrc/lstm_encoder.cu)
NWARPS = 16            # warps a CTA
ROWS = 32              # rows of a job (two m16 tiles)
PAD = 8                # bf16 of padding a weight-slab row
MAX_SPLITS = 8
# the opt-in shared memory of a Hopper block (232,448 bytes) less 1 KB for
# the kernel's static shared memory
SMEM_LIMIT = 227 * 1024 - 1024
# batches of at least this many rows split the grid into two row groups:
# on an H100 one group is faster up to one job's 32 rows, two from 48 rows
# (PERF.md, "Row groups and K splits")
ROW_GROUP_MIN_B = ROWS + 1


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(units: int, E: int, R: int, L: int, splits: int, rows: int) -> int:
    """A CTA's shared memory (``Smem`` in csrc/lstm_encoder.cu): its weight
    slabs [4U][K + PAD] bf16, the summed biases, the gate sums of ``splits``
    K splits for ``rows`` rows and both layers, and c, all f32."""
    N, E16 = 4 * units, _ceil(E, 16) * 16
    slabs = N * (E16 + R + PAD) * 2 + (N * (2 * R + PAD) * 2 if L > 1 else 0)
    return slabs + L * N * 4 + L * splits * rows * N * 4 + L * rows * units * 4


@dataclasses.dataclass(frozen=True)
class LstmPlan:
    """How the kernel's grid covers the work.  ``row_groups`` groups of
    ``R // units`` CTAs each own every hidden unit once, ``units`` a CTA,
    for ``rows`` rows a pass; ``splits`` K splits a job; ``passes`` passes
    over the batch; ``smem`` bytes of shared memory a CTA."""
    units: int
    row_groups: int
    splits: int
    rows: int
    passes: int
    ctas: int
    smem: int

    def cta_units(self, R: int, cta: int) -> Tuple[int, range]:
        """(row group, hidden units) of CTA ``cta``, as the kernel takes them."""
        per_group = R // self.units
        u0 = (cta % per_group) * self.units
        return cta // per_group, range(u0, u0 + self.units)


def lstm_plan(B: int, E: int, R: int, L: int, n_sm: int,
              smem_limit: int = SMEM_LIMIT,
              row_groups: Optional[int] = None) -> LstmPlan:
    """The grid for a batch of ``B`` rows on a card with ``n_sm`` SMs: at most
    ``n_sm`` CTAs (the grid is cooperative), each with ``units`` a power of
    two from 2 to 16; two row groups from ``ROW_GROUP_MIN_B`` rows.  Raises
    ``ValueError`` for a shape the kernel does not take."""
    if not 1 <= L <= 2:
        raise ValueError(f"lstm_encode: the kernel takes 1 or 2 layers, got {L}")
    if R % 32 or not 32 <= R <= 512:
        raise ValueError(f"lstm_encode: rnn_size {R} must be a multiple of 32 "
                         "and at most 512")
    if B < 1 or E < 1:
        raise ValueError(f"lstm_encode: needs B >= 1 and E >= 1, got {B}, {E}")
    rg = row_groups or (2 if B >= ROW_GROUP_MIN_B else 1)
    units = 2
    while rg * (R // units) > n_sm and units < 16:
        units *= 2
    if rg * (R // units) > n_sm:
        raise ValueError(f"lstm_encode: {rg} row group(s) of {R} units need at "
                         f"least {rg * R // 16} SMs, the card has {n_sm}")
    # one pass holds every row if that fits, with the K splits that leave
    # the warps the least work each (jobs come in rounds of NWARPS); else the
    # most rows that fit, unsplit
    rows = _ceil(_ceil(B, rg), ROWS) * ROWS
    jobs = L * (rows // ROWS)
    splits = min(range(1, MAX_SPLITS + 1),
                 key=lambda s: (_ceil(jobs * s, NWARPS) / s, s))
    if smem_bytes(units, E, R, L, splits, rows) > smem_limit:
        splits = 1
        per_row = smem_bytes(units, E, R, L, 1, 1) - smem_bytes(units, E, R, L, 1, 0)
        fit = (smem_limit - smem_bytes(units, E, R, L, 1, 0)) // per_row // ROWS * ROWS
        rows = min(rows, fit)
        if rows < ROWS:
            if row_groups is None and rg > 1:
                return lstm_plan(B, E, R, L, n_sm, smem_limit, row_groups=1)
            raise ValueError(
                f"lstm_encode: embed_dim {E} with rnn_size {R}: a CTA's weight "
                f"slabs and {ROWS} rows take "
                f"{smem_bytes(units, E, R, L, 1, ROWS)} bytes of shared memory, "
                f"more than the {smem_limit} a block may have")
    return LstmPlan(units=units, row_groups=rg, splits=splits, rows=rows,
                    passes=_ceil(B, rg * rows), ctas=rg * (R // units),
                    smem=smem_bytes(units, E, R, L, splits, rows))


@functools.lru_cache(maxsize=None)
def _card(index: int) -> Tuple[int, int]:
    """(SM count, opt-in shared memory a block less 1 KB) of a CUDA device."""
    props = torch.cuda.get_device_properties(index)
    optin = getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT + 1024)
    return props.multi_processor_count, optin - 1024


def dot(x: torch.Tensor, w: torch.Tensor, dot_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` with both operands rounded to ``dot_dtype`` and the products
    summed in float32 (the Pallas kernels' ``preferred_element_type=f32``)."""
    return x.to(dot_dtype).float() @ w.to(dot_dtype).float()


def pack_encoder_weights(rnn: Dict) -> Dict:
    """The DeepLSTM weights for the kernel, made once per parameter set.

    ``layers``: the weights and biases in bf16 (the Pallas wrapper casts the
    same tensors per call), which the plain version reads.  ``slabs``: per
    layer the stacked ``[wi; wh]`` in bf16 as ``[R, 4, K]``, element
    ``[j, g, k]`` the stacked row k of gate column ``g R + j``; layer 0's
    ``wi`` rows are padded with zeros from E to a multiple of 16.
    ``bias``: ``[L, R, 4]`` float32, ``bi + bh`` of the bf16 biases."""
    layers = map_tree(lambda w: w.to(torch.bfloat16).contiguous(), rnn)
    slabs, bias = [], []
    for L, lp in enumerate(layers["layers"]):
        wi, wh = lp["wi"], lp["wh"]
        R = wh.shape[0]
        pad = (-wi.shape[0]) % 16 if L == 0 else 0
        stacked = torch.cat([wi, wi.new_zeros(pad, 4 * R), wh])
        slabs.append(stacked.reshape(-1, 4, R).permute(2, 1, 0).contiguous())
        bias.append((lp["bi"].float() + lp["bh"].float()).reshape(4, R).T)
    return {**layers, "slabs": slabs, "bias": torch.stack(bias).contiguous()}


def lstm_encode_reference(rnn: Dict, cfg: ModelConfig, emb: torch.Tensor,
                          lengths: torch.Tensor, *,
                          dot_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version: emb [B, T, E] (after the embedding tanh), lengths [B]
    -> packed state [B, 2*n*R] at each row's last token, the rows whose
    length is outside [1, T] left at zero (``_kernel`` :57-77)."""
    B, T, _ = emb.shape
    R = cfg.rnn_size
    layers = map_tree(lambda w: w.float(), rnn["layers"])
    state = emb.new_zeros(B, 2 * R * len(layers), dtype=torch.float32)
    out = torch.zeros_like(state)
    lengths = lengths.to(emb.device)
    for t in range(T):
        inp = emb[:, t].float()
        parts = []
        for L, lp in enumerate(layers):
            c = state[:, 2 * L * R:(2 * L + 1) * R]
            h = state[:, (2 * L + 1) * R:(2 * L + 2) * R]
            gates = (dot(inp, lp["wi"], dot_dtype) + lp["bi"]
                     + dot(h, lp["wh"], dot_dtype) + lp["bh"])
            sig = torch.sigmoid(gates[:, :3 * R])
            i_g, f_g, o_g = sig[:, :R], sig[:, R:2 * R], sig[:, 2 * R:]
            nc = f_g * c + i_g * torch.tanh(gates[:, 3 * R:])
            nh = o_g * torch.tanh(nc)
            parts += [nc, nh]
            inp = nh
        state = torch.cat(parts, dim=1)
        out = torch.where((lengths == t + 1)[:, None], state, out)
    return out


def lstm_encode(enc: Dict, cfg: ModelConfig, emb: torch.Tensor,
                lengths: torch.Tensor, *,
                plan: Optional[LstmPlan] = None) -> torch.Tensor:
    """The encoder scan.  ``enc`` comes from ``pack_encoder_weights``.

    A CUDA ``emb`` launches the kernel once (or raises), with ``plan`` or
    ``lstm_plan``'s for this batch and card; a CPU ``emb`` runs
    ``lstm_encode_reference`` with bf16 dots, the kernel's arithmetic."""
    if emb.device.type == "cpu":
        return lstm_encode_reference(enc, cfg, emb, lengths,
                                     dot_dtype=torch.bfloat16)
    if emb.device.type != "cuda":
        raise ValueError(f"lstm_encode: unsupported device {emb.device}")
    B, T, E = emb.shape
    R, n = cfg.rnn_size, cfg.rnn_layers
    if len(enc["layers"]) != n:
        raise ValueError(f"lstm_encode: {len(enc['layers'])} layers of weights "
                         f"for rnn_layers {n}")
    n_sm, smem_limit = _card(emb.device.index or 0)
    plan = plan or lstm_plan(B, E, R, n, n_sm, smem_limit)
    if emb.dtype != torch.float32 or not emb.is_contiguous():
        raise ValueError("lstm_encode: emb must be contiguous float32")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 \
            or lengths.device != emb.device:
        raise ValueError("lstm_encode: lengths must be int32 [B] on emb's device")
    E16 = _ceil(E, 16) * 16
    want = [(w, (R, 4, (E16 + R) if L == 0 else 2 * R), torch.bfloat16, f"slab {L}")
            for L, w in enumerate(enc["slabs"])]
    want.append((enc["bias"], (n, R, 4), torch.float32, "bias"))
    for w, shape, dtype, name in want:
        if (w.dtype != dtype or tuple(w.shape) != shape
                or not w.is_contiguous() or w.device != emb.device):
            raise ValueError(f"lstm_encode: {name} must be contiguous {dtype} "
                             f"{shape} on {emb.device}; pack_encoder_weights makes it")
    rows = plan.row_groups * plan.rows      # rows a pass
    dev = emb.device
    xbuf = torch.empty(T * rows * E16, device=dev, dtype=torch.bfloat16)
    hbuf = torch.empty(n * 2 * rows * R, device=dev, dtype=torch.bfloat16)
    out = torch.empty(B, 2 * n * R, device=dev, dtype=torch.float32)
    slabs = enc["slabs"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    KERNEL.launch(emb.data_ptr(), lengths.data_ptr(), slabs[0].data_ptr(),
                  slabs[-1].data_ptr() if n > 1 else 0, enc["bias"].data_ptr(),
                  xbuf.data_ptr(), hbuf.data_ptr(), out.data_ptr(),
                  B, T, E, R, n, plan.units, plan.row_groups, plan.splits,
                  plan.rows, plan.smem, stream)
    return out


def encode_question_fused(params: Dict, enc: Dict, cfg: ModelConfig,
                          tokens: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Embedding gather + tanh in PyTorch, the LSTM scan in ``lstm_encode``."""
    emb = embed_question(params, tokens).contiguous()
    return lstm_encode(enc, cfg, emb, lengths)
