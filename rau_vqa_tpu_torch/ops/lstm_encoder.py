"""Question-encoder LSTM scan: a CUDA kernel and its plain version.

Counterpart of ``rau_vqa_tpu/ops/lstm_encoder.py``.  ``lstm_encode`` runs the
whole 2-layer DeepLSTM over all tokens in one launch of
``csrc/lstm_encoder.cu`` for a CUDA tensor, and ``lstm_encode_reference``
(the same math in plain PyTorch) for a CPU tensor.  The kernel takes its
weights in bf16, cast once by ``pack_encoder_weights``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from rau_vqa_tpu_torch.config import ModelConfig
from rau_vqa_tpu_torch.convert import map_tree
from rau_vqa_tpu_torch.models.rau import embed_question
from rau_vqa_tpu_torch.ops._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel("lstm_encoder", "lstm_encode_launch",
                [_P] * 11 + [_I] * 5 + [_P])


def dot(x: torch.Tensor, w: torch.Tensor, dot_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` with both operands rounded to ``dot_dtype`` and the products
    summed in float32 (the Pallas kernels' ``preferred_element_type=f32``)."""
    return x.to(dot_dtype).float() @ w.to(dot_dtype).float()


def pack_encoder_weights(rnn: Dict) -> Dict:
    """The DeepLSTM weights and biases in bf16, contiguous, as the kernel
    reads them (the Pallas wrapper casts the same tensors per call)."""
    return map_tree(lambda w: w.to(torch.bfloat16).contiguous(), rnn)


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
                lengths: torch.Tensor) -> torch.Tensor:
    """The encoder scan.  ``enc`` comes from ``pack_encoder_weights``.

    A CUDA ``emb`` launches the kernel (or raises); a CPU ``emb`` runs
    ``lstm_encode_reference`` with bf16 dots, the kernel's arithmetic."""
    if emb.device.type == "cpu":
        return lstm_encode_reference(enc, cfg, emb, lengths,
                                     dot_dtype=torch.bfloat16)
    if emb.device.type != "cuda":
        raise ValueError(f"lstm_encode: unsupported device {emb.device}")
    B, T, E = emb.shape
    R, n = cfg.rnn_size, cfg.rnn_layers
    layers = enc["layers"]
    if not 1 <= n <= 2 or len(layers) != n:
        raise ValueError(f"lstm_encode: kernel takes 1 or 2 layers, got {n}")
    if R % 32 or R > 512:
        raise ValueError(f"lstm_encode: rnn_size {R} must be a multiple of "
                         "32 and at most 512")
    if emb.dtype != torch.float32 or not emb.is_contiguous():
        raise ValueError("lstm_encode: emb must be contiguous float32")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 \
            or lengths.device != emb.device:
        raise ValueError("lstm_encode: lengths must be int32 [B] on emb's device")
    for L, lp in enumerate(layers):
        k_in = E if L == 0 else R
        want = {"wi": (k_in, 4 * R), "bi": (4 * R,),
                "wh": (R, 4 * R), "bh": (4 * R,)}
        for k, shape in want.items():
            w = lp[k]
            if (w.dtype != torch.bfloat16 or tuple(w.shape) != shape
                    or not w.is_contiguous() or w.device != emb.device):
                raise ValueError(f"lstm_encode: layer {L} {k} must be "
                                 f"contiguous bf16 {shape} on {emb.device}")
    out = torch.empty(B, 2 * n * R, device=emb.device, dtype=torch.float32)
    ptrs = [w.data_ptr() for lp in layers for w in
            (lp["wi"], lp["bi"], lp["wh"], lp["bh"])]
    ptrs += [0] * (8 - len(ptrs))
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    KERNEL.launch(emb.data_ptr(), lengths.data_ptr(), *ptrs, out.data_ptr(),
                  B, T, E, R, n, stream)
    return out


def encode_question_fused(params: Dict, enc: Dict, cfg: ModelConfig,
                          tokens: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Embedding gather + tanh in PyTorch, the LSTM scan in ``lstm_encode``."""
    emb = embed_question(params, tokens).contiguous()
    return lstm_encode(enc, cfg, emb, lengths)
