"""Serving throughput bench of the port: VQA questions/s on one card.

The port's counterpart of the root ``bench.py``.  It runs ``ours_ms`` as the
port serves it (``predict_fused``: the question-LSTM and hop-loop kernels
with bf16 dots) on random weights from seed 0, at ``--batch`` questions (512
by default, the batch of PERF.md's main-path metric) with 14x14x512
features: K serving steps chained by a data dependence (``eval/chain.py``),
enqueued eagerly, each round timed with CUDA events around its K steps and
synchronised once.  No CUDA graph: the bench measures what the service runs.

    python3 bench_torch.py [--batch 512] [--artifact [DIR]]

``--artifact`` runs the chain from its ``torch.export`` artifact
(``eval/export.py`` kind ``serve_chain``, built in DIR if missing or
stale).  Prints one JSON line: ``metric``, ``value`` (questions/s),
``unit``, ``spread``, ``compile_s`` (the kernels' nvcc builds, before the
timed window), ``compile_first_s`` (the first chain, libraries loaded),
``operand_upload_s``, the bf16 canary's ``rig_canary_tflops`` and
``rig_canary_frac_peak``, ``mfu`` (the step's analytic FLOPs,
``utils/flops.py``, over its time against the 989 TFLOP/s dense bf16 peak),
``device`` and ``power_limit_w``, and ``artifact`` when one was used.  On the
CPU (``--device cpu``, a smoke of the code) the device metrics are null.
``RAU_BENCH_B`` / ``RAU_BENCH_K`` / ``RAU_BENCH_ROUNDS`` set the batch, the
chain and the rounds for such smokes.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from rau_vqa_tpu_torch.ops import _build

METRIC = "vqa_questions_per_sec_per_chip"
UNIT = "questions/sec"
DEFAULT_ARTIFACT = os.path.join(_build.BUILD_DIR, "artifacts", "serve_chain")
SERVING_KERNELS = ("lstm_encoder", "rau_hops")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_kernels(device: torch.device, names) -> float:
    """Build the kernels before the timed window; their seconds
    (``compile_s``), None on the CPU."""
    if device.type != "cuda":
        return None
    t0 = time.perf_counter()
    _build.build_all(list(names))
    return time.perf_counter() - t0


def upload(device: torch.device, *arrays) -> Tuple[list, float]:
    """The host arrays on ``device``, and the seconds the copies took."""
    t0 = time.perf_counter()
    out = [torch.as_tensor(a, device=device) for a in arrays]
    _sync(device)
    return out, time.perf_counter() - t0


def chain_rounds(call: Callable, rounds: int, device: torch.device):
    """(seconds of the first call, seconds of each timed round, the last
    round's output) of ``call(salt0)``: a first call, one warm call, then
    ``rounds`` rounds, each timed with CUDA events on the card (the host's
    clock on the CPU) and synchronised once."""
    def salt(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    t0 = time.perf_counter()
    call(salt(0))
    _sync(device)
    t_first = time.perf_counter() - t0
    call(salt(5))
    _sync(device)
    times: List[float] = []
    out = None
    for r in range(rounds):
        s = salt(100 + r)
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = call(s)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = call(s)
            times.append(time.perf_counter() - t0)
    return t_first, times, out


def result_line(metric: str, per_round: float, times: List[float], K: int, flops: float,
                device: torch.device, canary: Dict, **extra) -> Dict:
    """The bench's JSON line: ``value`` is ``per_round`` units over the
    median round; ``mfu`` and the canary's share only on the card."""
    from rau_vqa_tpu_torch.utils.flops import H100_BF16_FLOPS
    from rau_vqa_tpu_torch.utils.rigcheck import card_info

    dt = float(np.median(times))
    on_card = device.type == "cuda"
    name, limit = card_info() if on_card else ("cpu", None)
    return {"metric": metric, "value": round(per_round / dt, 1), "unit": UNIT,
            "spread": round((max(times) - min(times)) / dt, 4),
            "step_ms": round(dt / K * 1e3, 4), "flops_per_step": flops,
            "mfu": round(flops / (dt / K) / H100_BF16_FLOPS, 5) if on_card else None,
            "rig_canary_tflops": canary["tflops"] if on_card else None,
            "rig_canary_frac_peak": canary["frac_of_peak"] if on_card else None,
            "device": (name or torch.cuda.get_device_name(device)) if on_card else "cpu",
            "power_limit_w": limit, **extra}


def run_bench(metric: str, device: torch.device, body: Callable[[], Dict]) -> int:
    """``body`` without autograd under the scripts' harness
    (``scripts/_common.py`` ``run_script``: the watchdog, the card's
    preflight, the line printed and kept as a record on the card; exit code
    3 with the error line when the card is absent or hung)."""
    from rau_vqa_tpu_torch.scripts._common import run_script

    def no_grad_body() -> Dict:
        with torch.no_grad():
            return body()

    return run_script(metric, UNIT, device, no_grad_body)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=_env_int("RAU_BENCH_B", 512),
                    help="questions a step (default 512)")
    ap.add_argument("--artifact", metavar="DIR", nargs="?", const=DEFAULT_ARTIFACT,
                    default=None,
                    help="time the chain from its torch.export artifact in DIR (built "
                         f"there if missing or stale; default {DEFAULT_ARTIFACT})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; exit 3 without a card) or cpu (a smoke)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    B, K = args.batch, _env_int("RAU_BENCH_K", 30)
    rounds = _env_int("RAU_BENCH_ROUNDS", 5)
    if min(B, K, rounds) < 1:
        raise SystemExit("batch, chain and rounds must be >= 1")

    def body() -> Dict:
        from rau_vqa_tpu_torch.config import get_preset
        from rau_vqa_tpu_torch.eval.chain import make_serve_chain
        from rau_vqa_tpu_torch.models.rau import init_params
        from rau_vqa_tpu_torch.utils.flops import serve_step_flops
        from rau_vqa_tpu_torch.utils.rigcheck import matmul_canary

        compile_s = build_kernels(device, SERVING_KERNELS)
        cfg = get_preset("ours_ms")
        params = init_params(cfg, torch.Generator().manual_seed(0), device)
        rs = np.random.RandomState(0)
        # host data made before the upload's clock starts
        h_tokens = rs.randint(1, cfg.vocab_size, (B, cfg.seq_len)).astype(np.int32)
        h_lengths = rs.randint(1, cfg.seq_len + 1, B).astype(np.int32)
        h_feats = rs.randn(B, cfg.cnn_spat, cfg.cnn_dim).astype(np.float32)
        (tokens, lengths, feats), t_up = upload(device, h_tokens, h_lengths, h_feats)
        log(f"bench: operand upload {t_up:.3f}s "
            f"({(h_tokens.nbytes + h_lengths.nbytes + h_feats.nbytes) / 1e6:.0f} MB)")
        extra = {}
        if args.artifact:
            from rau_vqa_tpu_torch.eval.export import (
                export_serve_chain,
                load_or_build_chain_artifact,
            )
            t0 = time.perf_counter()
            chain = load_or_build_chain_artifact(
                args.artifact,
                lambda: export_serve_chain(params, cfg, args.artifact, batch=B, chain=K,
                                           device=device),
                {"kind": "serve_chain", "batch": B, "chain": K, "fused": True,
                 "device": device.type, "model_config": dataclasses.asdict(cfg)}, log=log)
            chain.program()
            extra = {"artifact": True,
                     "artifact_s": round(time.perf_counter() - t0, 3)}
            log(f"bench: artifact ready in {extra['artifact_s']}s (built or loaded)")
        else:
            chain = make_serve_chain(cfg, K)
        t_first, times, (_, acc) = chain_rounds(
            lambda s: chain(params, tokens, lengths, feats, s), rounds, device)
        if tuple(acc.shape) != (cfg.n_hops + 2, min(8, B)):
            raise RuntimeError(f"bench: the chain's acc has shape {tuple(acc.shape)}")
        canary = matmul_canary(device=device)
        flops = serve_step_flops(cfg, B, int(h_lengths.sum()))
        line = result_line(METRIC, K * B, times, K, flops, device, canary,
                           compile_s=None if compile_s is None else round(compile_s, 3),
                           compile_first_s=round(t_first, 3),
                           operand_upload_s=round(t_up, 3), batch=B, chain=K,
                           rounds=rounds, **extra)
        log(f"bench: {line['step_ms']} ms a step of {B} (median of {rounds}, spread "
            f"{line['spread'] * 100:.1f}%: "
            + ", ".join(f"{t / K * 1e3:.3f}" for t in times) + " ms); "
            f"canary {canary['tflops']} TFLOP/s; mfu {line['mfu']}")
        return line

    return run_bench(METRIC, device, body)


if __name__ == "__main__":
    sys.exit(main())
