"""Witness for the full-width LM learning rate: yi-6b at full width, cut to
2 layers and one 32-token row with float32 activations, 3 AdamW steps from
the same seeded parameters (``chip_smoke.lm_params``, true fan-in) and
batches, once through the reference (JAX on the CPU) and once through the
port (on the CPU). That is the configuration of ``chip_smoke.py``'s
card-against-CPU gate for yi-6b, whose card run is held against the
reference losses this script prints (``YI_2L_REFERENCE_LOSSES`` there).

    PYTHONPATH=src python tests/torch_lm_lr_witness.py [--lr 1e-3]

Each side runs in a process of its own: float32 parameters, gradients and
AdamW's m and v for 0.87 B parameters take about 14 GB of host memory.
Prints one JSON line: each side's losses and grad norms, and their largest
relative gaps.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

LAYERS = 2


def _setup():
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import LMStream

    cfg = dataclasses.replace(get_config("yi-6b").model, n_layers=LAYERS,
                              act_dtype=torch.float32)
    params = cs.lm_params(cfg, torch.Generator().manual_seed(cs.SEED))
    stream = LMStream(cfg.vocab, *cs.TRAIN_CMP_TOKENS, seed=cs.SEED)
    return cs, cfg, params, [stream.batch_at(i) for i in range(cs.TRAIN_STEPS)]


def port_side(lr: float) -> dict:
    import torch

    from repro_torch.models import transformer as tfm

    cs, cfg, params, batches = _setup()
    _, _, info = cs.train_run(torch, functools.partial(tfm.lm_loss, cfg), params,
                              [{k: torch.as_tensor(v) for k, v in b.items()} for b in batches],
                              lr=lr)
    return {"losses": info["losses"], "grad_norms": info["grad_norms"]}


def reference_side(lr: float) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import transformer as jtfm
    from repro.train import optimizer as jopt
    from repro.train.train_loop import TrainConfig, make_train_step

    _, _, params, batches = _setup()
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    del params
    jcfg = dataclasses.replace(jget_config("yi-6b").model, n_layers=LAYERS,
                               act_dtype=jnp.float32)
    tcfg = TrainConfig(adamw=jopt.AdamWConfig(lr=lr))
    step = jax.jit(make_train_step(functools.partial(jtfm.lm_loss, jcfg, jtfm.Constraints()),
                                   tcfg), donate_argnums=(0, 1))
    state = jopt.init_opt_state(jp, tcfg.adamw)
    out = {"losses": [], "grad_norms": []}
    for b in batches:
        jp, state, m = step(jp, state, {k: jnp.asarray(v) for k, v in b.items()})
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--side", choices=["port", "reference"], default=None,
                    help="run one side and write its JSON to --out (the default runs both)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.side is not None:
        res = (port_side if args.side == "port" else reference_side)(args.lr)
        Path(args.out).write_text(json.dumps(res))
        return
    res = {"config": f"yi-6b full width, {LAYERS} layers, float32", "lr": args.lr}
    with tempfile.TemporaryDirectory() as d:
        for side in ("reference", "port"):
            out = f"{d}/{side}.json"
            subprocess.run([sys.executable, __file__, "--side", side, "--lr", str(args.lr),
                            "--out", out], check=True)
            res[side] = json.loads(Path(out).read_text())
    for key in ("losses", "grad_norms"):
        res[f"{key}_max_rel"] = max(abs(a / b - 1) for a, b in
                                    zip(res["port"][key], res["reference"][key]))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
