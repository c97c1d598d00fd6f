"""Probe of the training hop loop's two kernels on one CUDA card (an H100).

    python3 bench_torch_train_hops.py [--seed N] [--batch 100] [--check]

At ``ours_ms`` widths (random weights from the seed, mult_dropout 0.5, 8
hops), builds ``csrc/rau_train_hops_fwd.cu`` and ``csrc/rau_train_hops_bwd.cu``
and prints, beside the card's name and power limit, for float32 and bf16
products:

- each phase kernel's registers, shared memory and spills (ptxas);
- ``train_hops_fwd`` and ``train_hops_bwd`` at B=--batch, CUDA-event mean
  of 10 calls, beside their bounds (chip_smoke.train_fwd_bound,
  train_bwd_bound) and their plain versions;
- each phase of ``fwd_plan`` and of ``bwd_plan`` summed over the hops,
  beside that phase's own bound: its operands read once and its output
  written once over 3.35 TB/s, or its products over the type's peak (67
  TFLOP/s float32 FMA, 989 TFLOP/s bf16 tensor cores), the larger (the
  forward's classifier and do_pred are tile GEMMs like the others).  The
  phase times are the device times of the call's kernels under
  torch.profiler (mean of 3 calls), taken in stream order, which is the
  plan's order hop after hop; their sum leaves out the gaps between
  kernels.

With ``--check``, first holds each kernel to its plain version at B in {19,
100}: the float32 forward at rtol / atol 1e-4, the float32 backward's
emissions and grads within 1e-3 norm-relative, the bf16 instantiations at
``chip_smoke.py``'s bars (one hop: ``TRAIN_BF16_BARS``; eight hops:
``train_bf16_deep_bar``), two calls of each bit-equal.  Exits 2 without a
card, 1 if a check fails.

With ``--readings``, first prints the bf16 kernels' readings against their
plain versions (``train_bf16_readings``) over 18 seeded cases, one or eight
hops at B in {1, 19, 37, 100} (the card tests' cases and 12 more), each as
a share of its bar: the worst leaf of each kernel a case, the worst share
of each leaf over all cases, and the leaves beyond their bar.  Imports
nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from chip_smoke import (
    H100_BF16_FLOPS,
    H100_BYTES_PER_S,
    H100_F32_FLOPS,
    card_line,
    make_batch,
    norm_rel,
    phase_kernel_label,
    time_ms,
    train_bf16_bar,
    train_bf16_deep_bar,
    train_bf16_readings,
    train_bwd_bound,
    train_fwd_bound,
)


def phase_bound(ph, B, S, Dc, M, F, R, Q, chunks, e, peak):
    """(ms, "bytes" | "operations") of one phase at one hop."""
    def b(n_bytes, n_ops=0.0):
        t_b, t_o = n_bytes / H100_BYTES_PER_S * 1e3, n_ops / peak * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    P = B * S
    if ph.tile is not None:
        out = ph.M * ph.N * 4 * (chunks if ph.split else 1)
        return b((ph.M * ph.K + ph.K * ph.N) * e + out, 2.0 * ph.M * ph.N * ph.K)
    sizes = {"prep": (B * Q + P * Dc) * (e + e),
             "rows_fwd": P * (M + F) * 4 + B * (S + M) * 4,
             "cell": B * R * 4 * 4 + B * R * 4 * 3,
             "cell_bwd": B * R * 4 * 4 + B * R * 4 * 4 + B * R * 4 * 4,
             "softmax_bwd": P * M * 4 + B * (3 * S + M) * 4,
             "dpre_add": P * F * 4 * 2 + B * (S + 2 * F) * 4,
             "colsum": P * M * 4 + -(-P // 128) * M * 4,
             "reduce": chunks * (Dc * M + M * F + M) * 4 + 2 * B * F * 4
             + (Dc * M + M * F + M + 2 * F) * 8}
    return b(sizes[ph.name])


def phase_times(fns, H, ns, calls):
    """For each fn of ``fns`` (a call of n = ``ns[i]`` phases a hop): the
    device ms of each phase, summed over the H hops and averaged over
    ``calls`` calls, from one profiler session that runs every fn ``calls``
    times in turn: its kernel records (not memsets or copies) in the order
    they started."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            for _ in range(calls):
                fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and not e.name.startswith(("Memset", "Memcpy"))),
                     key=lambda e: e.time_range.start)
    want = calls * H * sum(ns)
    if len(kernels) != want:
        raise SystemExit(f"the profiler recorded {len(kernels)} kernels, not {want}")
    ms = np.asarray([e.time_range.elapsed_us() / 1e3 for e in kernels])
    out, at = [], 0
    for n in ns:
        out.append(ms[at:at + calls * H * n].reshape(calls, H, n).sum(1).mean(0))
        at += calls * H * n
    return out


def check(rth, cfg, mp, rs, dev) -> list:
    """The kernel against its plain version; returns the failures."""
    failed = []
    H, A, Q = cfg.n_hops, cfg.answer_size, cfg.rnnout_dim
    for B in (19, 100):
        feats = make_batch(cfg, B, cfg.seq_len, rs, dev)[2]
        q = torch.as_tensor(0.5 * rs.randn(B, Q).astype(np.float32), device=dev)
        seed = torch.tensor([rs.randint(0, 2 ** 31 - 1)], dtype=torch.int32, device=dev)
        out = rth.train_hops_fwd(mp, cfg, q, feats, seed)
        again = rth.train_hops_fwd(mp, cfg, q, feats, seed)
        want = rth.train_hops_fwd_reference(mp, cfg, q, feats, seed)
        torch.cuda.synchronize()
        same = all(torch.equal(g, a) for g, a in zip(out, again))
        names = ("scores", "do_pred", "attprob", "c_all", "h_all")
        close = {n: torch.allclose(g, w, rtol=1e-4, atol=1e-4)
                 for n, g, w in zip(names, out, want)}
        print(f"train_hops_fwd float32 B={B}: max_abs_err "
              + ", ".join(f"{n} {(g - w).abs().max().item():.2e}"
                          for n, g, w in zip(names, out, want))
              + f" (bar rtol / atol 1e-4); two calls bit-equal: {same}", flush=True)
        if not all(close.values()) or not same:
            failed.append(f"forward float32 B={B}: within rtol / atol 1e-4 {close}, "
                          f"bit-equal {same}")
        _, _, _, c_all, h_all = out
        gen = torch.Generator(dev).manual_seed(B)
        gmerge = (1e-3 * torch.randn(H, B, A, device=dev, generator=gen)
                  @ mp["cls"]["w"].T).contiguous()
        args = (mp, cfg, q, feats, seed, c_all, h_all, gmerge)
        em, gw = rth.train_hops_bwd(*args)
        em2, gw2 = rth.train_hops_bwd(*args)
        want_em, want_gw = rth.train_hops_bwd_reference(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(em[k], em2[k]) for k in em) and all(
            torch.equal(gw[k], gw2[k]) for k in gw)
        rel = {k: norm_rel(em[k], want_em[k]) for k in em}
        rel.update({"/".join(k): norm_rel(gw[k], want_gw[k]) for k in gw})
        worst = max(rel, key=rel.get)
        print(f"train_hops_bwd float32 B={B}: worst norm-relative {rel[worst]:.3e} ({worst}); "
              + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
              + f"; two calls bit-equal: {same}", flush=True)
        if rel[worst] > 1e-3 or not same:
            failed.append(f"float32 B={B}: {worst} {rel[worst]:.3e}, bit-equal {same}")
    for H_b, B in ((1, 19), (1, 100), (8, 19), (8, 100)):
        cfg_b = dataclasses.replace(cfg, compute_dtype="bfloat16", n_hops=H_b)
        deep = H_b > 1
        readings = train_bf16_readings(rth, cfg_b, mp, B, rs, dev, host=deep)
        for kind, per in readings.items():
            bars = {k: (train_bf16_deep_bar(r) if deep else train_bf16_bar(kind, k))
                    for k, r in per.items()}
            print(f"train_hops_{kind}_bf16 H={H_b} B={B}, kernel / float32 plain (bar): "
                  + ", ".join(f"{k} {r['kernel']:.2e} / {r['float32']:.2e} ({bars[k]:.2e})"
                              for k, r in per.items()), flush=True)
            failed += [f"{kind} bf16 H={H_b} B={B}: {k} {r['kernel']:.3e} > {bars[k]:.3e}"
                       for k, r in per.items()
                       if r["float32"] > 0 and not r["kernel"] <= bars[k]]
    return failed


# (hops, batch, weight seed, input seed) of --readings: the card tests'
# six cases, then 12 more
READING_CASES = ([(1, 19, 2, 3), (8, 19, 2, 3), (8, 100, 2, 3), (1, 1, 4, 6), (1, 37, 4, 6),
                  (8, 37, 4, 6)] + [(1, 19, s, s + 10) for s in range(10, 16)]
                 + [(1, 100, s, s + 10) for s in range(10, 14)] + [(8, 19, 20, 30),
                                                                   (8, 100, 21, 31)])


def readings(rth, cfg, init_params, dev) -> None:
    """The bf16 kernels' readings as shares of their bars over READING_CASES."""
    worst = {"fwd": {}, "bwd": {}}
    over = 0
    for H, B, seed, rs_seed in READING_CASES:
        cfg_b = dataclasses.replace(cfg, compute_dtype="bfloat16", n_hops=H)
        mp = init_params(cfg, torch.Generator().manual_seed(seed), dev)["mult"]
        r = train_bf16_readings(rth, cfg_b, mp, B, np.random.RandomState(rs_seed), dev,
                                host=H > 1)
        line = []
        for kind, per in r.items():
            share = {}
            for name, x in per.items():
                bar = (train_bf16_deep_bar(x) if H > 1 else
                       train_bf16_bar(kind, name) if x["float32"] > 0 else 0.0)
                if bar > 0:
                    share[name] = x["kernel"] / bar
                    worst[kind][name] = max(worst[kind].get(name, 0.0), share[name])
            top = max(share, key=share.get)
            over += sum(v > 1 for v in share.values())
            line.append(f"{kind} worst {top} {share[top]:.3f}")
        print(f"readings H={H} B={B} seeds {seed}/{rs_seed}: " + "; ".join(line), flush=True)
    for kind, per in worst.items():
        print(f"readings {kind}, worst share of its bar by leaf: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:8]),
            flush=True)
    print(f"readings: {over} leaf readings beyond their bar in {len(READING_CASES)} cases",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--readings", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_train_hops: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from rau_vqa_tpu_torch.config import get_preset
    from rau_vqa_tpu_torch.convert import map_tree
    from rau_vqa_tpu_torch.models.rau import init_params
    from rau_vqa_tpu_torch.ops import _build
    from rau_vqa_tpu_torch.ops import rau_train_hops as rth

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    reports = _build.build_all(["rau_train_hops_fwd", "rau_train_hops_bwd"], force=True)
    for name, report in reports.items():
        entry = ""
        for line in report.splitlines():
            if "Compiling entry" in line:
                entry = phase_kernel_label(line)
            if "registers" in line or "spill" in line:
                print(f"ptxas {name} {entry}: {line.strip()}", flush=True)

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_preset("ours_ms"), fused_train=True)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed), dev)
    mp = params["mult"]
    rs = np.random.RandomState(args.seed)
    if args.readings:
        readings(rth, cfg, init_params, dev)
    if args.check:
        failed = check(rth, cfg, mp, rs, dev)
        if failed:
            print("check failed: " + "; ".join(failed), flush=True)
            return 1
        print("check: ok", flush=True)

    B, H, A = args.batch, cfg.n_hops, cfg.answer_size
    S, Dc, M, F, R, Q = (cfg.cnn_spat, cfg.cnn_dim, cfg.multfeat_dim, cfg.attfeat_dim,
                         cfg.att_state_dim, cfg.rnnout_dim)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    feats = make_batch(cfg, B, cfg.seq_len, rs, dev)[2]
    q = torch.as_tensor(0.5 * rs.randn(B, Q).astype(np.float32), device=dev)
    seed = torch.tensor([rs.randint(0, 2 ** 31 - 1)], dtype=torch.int32, device=dev)
    gen = torch.Generator(dev).manual_seed(args.seed)
    g_scores = 1e-3 * torch.randn(H, B, A, device=dev, generator=gen)
    runs = []   # (kernel, type, call, kernel ms, plain ms, plan, bound, chunks, e, peak)
    for dt, name in ((torch.float32, "float32"), (torch.bfloat16, "bf16")):
        cfg_t = dataclasses.replace(cfg, compute_dtype="float32" if name == "float32"
                                    else "bfloat16")
        mp_t = map_tree(lambda w: w.to(dt), mp)
        e, peak = (4, H100_F32_FLOPS) if dt == torch.float32 else (2, H100_BF16_FLOPS)
        with torch.no_grad():
            fcall = (mp_t, cfg_t, q.to(dt), feats.to(dt), seed)
            _, _, _, c_all, h_all = rth.train_hops_fwd(*fcall)
            gmerge = (rth._rnd(g_scores, dt) @ rth._rnd(mp_t["cls"]["w"], dt).T).contiguous()
            bcall = fcall + (c_all, h_all, gmerge)
            bplan = rth.bwd_plan(B, S, Dc, M, F, R, Q, n_sm, dt)
            runs.append((rth.train_hops_fwd, name, fcall,
                         time_ms(lambda: rth.train_hops_fwd(*fcall), iters=10),
                         time_ms(lambda: rth.train_hops_fwd_reference(*fcall), iters=3,
                                 warmup=1),
                         rth.fwd_plan(B, S, Dc, M, F, R, Q, A, n_sm, dt),
                         train_fwd_bound(cfg_t, mp_t, B, dt), 1, e, peak))
            runs.append((rth.train_hops_bwd, name, bcall,
                         time_ms(lambda: rth.train_hops_bwd(*bcall), iters=10),
                         time_ms(lambda: rth.train_hops_bwd_reference(*bcall), iters=3,
                                 warmup=1),
                         bplan, train_bwd_bound(cfg_t, mp_t, B, dt), bplan.chunks, e, peak))
    # one profiler session for all four (a second session may lose events)
    with torch.no_grad():
        sums = phase_times([lambda r=r: r[0](*r[2]) for r in runs], H,
                           [len(r[5].phases) for r in runs], calls=3)
    for (fn, name, _, k_ms, p_ms, plan, (b_ms, b_by), chunks, e, peak), ph_ms in zip(runs, sums):
        n = len(plan.phases)
        split = f"; {chunks} chunks of {plan.chunk_rows} rows" if fn is rth.train_hops_bwd else ""
        print(f"{fn.__name__} {name} B={B}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"bound_ms={b_ms:.4f} by {b_by}{split}; {n * H} kernels a call, their device "
              f"time {ph_ms.sum():.4f} ms [{card}]", flush=True)
        for ph, t in sorted(zip(plan.phases, ph_ms), key=lambda r: -r[1]):
            pb, by = phase_bound(ph, B, S, Dc, M, F, R, Q, chunks, e, peak)
            shape = (f" [{ph.M} x {ph.N}, K {ph.K}, tile {ph.tile[0]}x{ph.tile[1]}, grid "
                     f"{ph.grid}]" if ph.tile else f" [grid {ph.grid}]")
            print(f"  phase {ph.name:<14} {t:8.4f} ms over {H} hops ({t / ph_ms.sum():5.1%}), "
                  f"bound {pb * H:.4f} ms by {by}{shape} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
