"""The fine-tuning A/B (``ft_accuracy_ab``) diagnosed on the CPU, in the JAX
package and in the port, from one backbone draw.

The A/B's outcome hangs on its random tiny ViT: a frozen draw whose
features happen to carry the stripes lets the head-only arm learn the task
too.  Each package draws its own (``jax.random.PRNGKey(0)``,
``torch.Generator().manual_seed(0)``), so the port's card run and the JAX
rig's differ in their draw before any arithmetic.  This script separates
the two causes:

  arms        — the recipe's head-only warm-up, then the named arms, in one
                package: ``--side jax`` (the JAX script's own ``_build``
                and ``_run_arm``), ``--side port`` (the port's script with
                the JAX package's draw moved by ``params_from_jax``) or
                ``--side port-own`` (the port's script as it ships);
                ``--draw-seed s`` draws the tiny ViT from seed ``s`` in the
                package's own generator (``jax.random.PRNGKey(s)``,
                ``torch.Generator().manual_seed(s)`` through the port's
                ``vit_init``; ``--side port`` takes JAX's draw at ``s``);
  spread      — ``arms`` for each ``--seeds`` in each ``--sides``, several
                at a time (``--jobs``), then one table of each run's frozen
                and fine-tuned best held-out accuracy and their gap;
  cross-eval  — the port's frozen arm (its own draw) from a head-only
                snapshot for ``--epochs`` epochs, then its state scored by
                the port's ``evaluate`` and by the JAX package's on the same
                held-out split (``params_to_jax``): accuracies and answers.

    python tests/torch_port_ab_diagnosis.py arms --side jax --arms frozen,finetune --out jax.json
    python tests/torch_port_ab_diagnosis.py spread --seeds 0,1,2,3,4 --out spread.json
    python tests/torch_port_ab_diagnosis.py cross-eval --snapshot <head-only .pt> --epochs 45 --out x.json

The recipe is the JAX rig's (``--backbone vit --image-mode texture
--n-classes 8 --head-warmup 30 --epochs 60 --lr 3e-3 --batch-size 16
--n-train 960 --n-test 128``).  Every run is on the CPU: the JAX package
never runs on the card.  Results go to ``--out`` as JSON; the fixture and
the runs' snapshots under ``--root``.
"""

import argparse
import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "scripts"))

VIT = dict(image_size=64, patch=16, dim=16, depth=2, heads=4)


def recipe(epochs: int) -> argparse.Namespace:
    return argparse.Namespace(backbone="vit", image_mode="texture", n_classes=8,
                              head_warmup=30, epochs=epochs, lr=3e-3, batch_size=16,
                              n_train=960, n_test=128, bf16=True, backbone_lr_scale=1.0,
                              feat_norm=False, device="cpu")


def fixture(root: str) -> str:
    """The A/B's dataset (``ft_accuracy_ab``'s spec, texture mode)."""
    from rau_vqa_tpu_torch.data.fixtures import FixtureSpec, generate_fixture

    data = os.path.join(root, "fixture")
    if not os.path.exists(os.path.join(data, "vqa_prepro")):
        spec = FixtureSpec(n_train=960, n_test=128, n_images=40, n_answers=8,
                           n_img_classes=8, seed=13)
        generate_fixture(data, spec, images=True, image_size=64, uniform_img_assign=True,
                         image_mode="texture")
    return data


def jax_draw(seed: int = 0):
    """The JAX script's backbone: ``vit_init(PRNGKey(seed))``, as port tensors."""
    from rau_vqa_tpu.models.backbones.vit import ViTConfig, vit_init
    from rau_vqa_tpu_torch.convert import params_from_jax

    return params_from_jax(jax.tree.map(np.asarray, vit_init(jax.random.PRNGKey(seed),
                                                             ViTConfig(**VIT))))


def seed_jax_draw(seed: int) -> None:
    """Make the JAX script's ``vit_init(PRNGKey(0), cfg)`` draw from ``seed``."""
    from rau_vqa_tpu.models.backbones import vit

    init = vit.vit_init
    vit.vit_init = lambda key, cfg, dtype=jax.numpy.float32: init(
        jax.random.PRNGKey(seed), cfg, dtype)


def seed_port_draw(seed: int) -> None:
    """Make the port script's ``vit_init(manual_seed(0), ...)`` draw from ``seed``."""
    from rau_vqa_tpu_torch.models.backbones import vit

    init = vit.vit_init
    vit.vit_init = lambda gen, cfg, dtype=torch.float32, device=None: init(
        torch.Generator().manual_seed(seed), cfg, dtype, device)


def cmd_arms(a) -> dict:
    data = fixture(a.root)
    runs = os.path.join(a.root, f"runs_{a.side}_seed{a.draw_seed}")
    warm = argparse.Namespace(**{**vars(recipe(30)), "epochs": 30})
    out = {}
    if a.side == "jax":
        import ft_accuracy_ab as J

        seed_jax_draw(a.draw_seed)
        out["head_warmup"] = J._run_arm("head_warmup", data, os.path.join(runs, "head_warmup"),
                                        train_backbone=False, args=warm, save_final=True)
        for arm in a.arms.split(","):
            out[arm] = J._run_arm(arm, data, os.path.join(runs, arm),
                                  train_backbone=arm == "finetune", args=recipe(a.epochs),
                                  warm_start=out["head_warmup"]["snapshot"])
        return out
    from rau_vqa_tpu_torch.models.backbones import vit
    from rau_vqa_tpu_torch.scripts import ft_accuracy_ab as P

    if a.side == "port":
        drawn = jax_draw(a.draw_seed)
        vit.vit_init = lambda gen, cfg, device="cpu": drawn
    else:
        seed_port_draw(a.draw_seed)
    dev = torch.device("cpu")
    out["head_warmup"] = P.run_arm("head_warmup", data, os.path.join(runs, "head_warmup"),
                                   train_backbone=False, args=warm, device=dev, save_final=True)
    for arm in a.arms.split(","):
        out[arm] = P.run_arm(arm, data, os.path.join(runs, arm),
                             train_backbone=arm == "finetune", args=recipe(a.epochs),
                             device=dev, warm_start=out["head_warmup"]["snapshot"])
    return out


def cmd_spread(a) -> dict:
    """``arms`` in a subprocess a (side, seed), ``--jobs`` at a time, then the table."""
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    fixture(a.root)  # once, before the runs share it
    runs = [(side, int(s)) for s in a.seeds.split(",") for side in a.sides.split(",")]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"}

    def one(run):
        side, seed = run
        out = os.path.join(a.root, f"arms_{side}_seed{seed}.json")
        if not os.path.exists(out):
            with open(out + ".log", "w") as log:
                subprocess.run([sys.executable, os.path.abspath(__file__), "arms", "--side", side,
                                "--draw-seed", str(seed), "--epochs", str(a.epochs),
                                "--root", a.root, "--out", out],
                               env=env, stdout=log, stderr=subprocess.STDOUT, check=True)
        with open(out) as f:
            res = json.load(f)
        frozen, tuned = res["frozen"]["best_test_acc"], res["finetune"]["best_test_acc"]
        return {"side": side, "seed": seed, "frozen": frozen, "finetune": tuned,
                "gap": round(tuned - frozen, 4)}

    with ThreadPoolExecutor(a.jobs) as pool:
        table = list(pool.map(one, runs))
    return {"recipe": vars(recipe(a.epochs)), "runs": table}


def cmd_cross_eval(a) -> dict:
    import ft_accuracy_ab as J

    from rau_vqa_tpu_torch.convert import params_to_jax
    from rau_vqa_tpu_torch.scripts import ft_accuracy_ab as P
    from rau_vqa_tpu_torch.train.trainer import head_params

    data = fixture(a.root)
    args = recipe(a.epochs)
    port = P.build_trainer(data, os.path.join(a.root, "cross_port"), train_backbone=False,
                           args=args, device=torch.device("cpu"))
    port.restore(a.snapshot)
    for _ in range(a.epochs):
        port.train_epoch()
    ev_port = port.evaluate(write_submissions=False, return_rows=True)
    ref = J._build(data, os.path.join(a.root, "cross_jax"), train_backbone=False, args=args)
    ref.bb_params = jax.device_put(params_to_jax(port.bb_params))
    ref._featurize = None
    ref.state = ref.state._replace(params=jax.tree.map(
        jax.numpy.asarray, params_to_jax(head_params(port.state.params))))
    ev_jax = ref.evaluate(write_submissions=False, return_rows=True)
    return {"epoch": port.epoch, "port_testOEacc": ev_port["testOEacc"],
            "jax_testOEacc": ev_jax["testOEacc"],
            "answers_equal": [float(np.mean([x == y for x, y in zip(p, j)]))
                              for p, j in zip(ev_port["rows_oe"], ev_jax["rows_oe"])]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("arms")
    r.add_argument("--side", choices=("jax", "port", "port-own"), required=True)
    r.add_argument("--arms", default="frozen,finetune")
    r.add_argument("--epochs", type=int, default=60)
    r.add_argument("--draw-seed", type=int, default=0,
                   help="the tiny ViT's draw, in the package's own generator")
    sp = sub.add_parser("spread")
    sp.add_argument("--seeds", default="0,1,2,3,4")
    sp.add_argument("--sides", default="jax,port-own")
    sp.add_argument("--epochs", type=int, default=60)
    sp.add_argument("--jobs", type=int, default=4)
    c = sub.add_parser("cross-eval")
    c.add_argument("--snapshot", required=True, help="the port's head-only snapshot (.pt)")
    c.add_argument("--epochs", type=int, default=45)
    for p in (r, sp, c):
        p.add_argument("--root", default=os.path.join(_REPO, ".scratch", "ab_diagnosis"))
        p.add_argument("--out", required=True)
    a = ap.parse_args()
    res = {"arms": cmd_arms, "spread": cmd_spread, "cross-eval": cmd_cross_eval}[a.cmd](a)
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1)
    if a.cmd == "spread":
        print("side      seed  frozen  finetune  gap")
        for r in res["runs"]:
            print(f"{r['side']:9} {r['seed']:4}  {r['frozen']:.4f}  {r['finetune']:.4f}    "
                  f"{r['gap']:+.4f}")
        return 0
    for name, v in res.items():
        print(name, v["best_test_acc"] if isinstance(v, dict) else v)
    return 0


if __name__ == "__main__":
    sys.exit(main())
