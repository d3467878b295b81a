"""Witness for the training cell left out of the benchmark: the port's
train step (``launch.steps.make_train_step``, AdamW with float32 moments
as ``launch/train.py`` builds it, remat "dots") on qwen3-0.6b at its
published widths updates its bfloat16 weights in place with no float32
copy, so a weight whose update is under half its bfloat16 spacing never
moves.  The norm weights (1.0, spacing 2**-8 below and 2**-7 above) stay
where they are at any learning rate under about 2e-3, while the optimizer
received a gradient for them (its first moment is not zero) and a float32
run moves them.

    python3 perfbench/tools/train_unmoved.py --seed 5 --steps 3 \
        --batch 4 --seq 4096 [--dtype float32] [--lr 3e-4]

Prints one JSON line: the leaves unmoved after the steps, by kind, the
first-moment norms of those leaves, and the losses."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--total-steps", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from perfbench.programs import decoder_lm
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import opt_config
    from repro_torch.train.tree import leaves
    conf = json.loads((ROOT / "perfbench/configs/qwen3-0.6b.json")
                      .read_text())
    conf["torch_dtype"] = args.dtype
    if args.device == "cpu":
        conf.update(hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=16, vocab_size=256)
    cfg = decoder_lm.model_config(conf)
    dev = torch.device(args.device)
    params = decoder_lm.make_weights(cfg, args.seed, dev, conf["weights"])
    # contiguous leaves of their own: the optimizer writes each in place
    params = _own(params)
    names = _names(params)
    before = [p.detach().clone() for p in leaves(params)]
    step, opt = make_train_step(cfg, opt_config(args.lr, args.total_steps),
                                remat=True, device=dev)
    state = opt.init(params)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    losses = []
    for _ in range(args.steps):
        toks = torch.randint(0, cfg.vocab, (args.batch, args.seq + 1),
                             generator=gen, device=dev, dtype=torch.int32)
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "labels": toks[:, 1:].contiguous()}
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    unmoved, moment = {}, {}
    for name, p0, p, mo in zip(names, before, leaves(params),
                               leaves(state["m"])):
        kind = _kind(name)
        if torch.equal(p0, p):
            unmoved[kind] = unmoved.get(kind, 0) + 1
            moment[kind] = max(moment.get(kind, 0.0), float(mo.norm()))
    total = {}
    for name in names:
        kind = _kind(name)
        total[kind] = total.get(kind, 0) + 1
    print(json.dumps({"dtype": args.dtype, "seed": args.seed,
                      "batch": [args.batch, args.seq], "steps": args.steps,
                      "lr": args.lr, "total_steps": args.total_steps,
                      "losses": losses, "leaves_by_kind": total,
                      "unmoved_by_kind": unmoved,
                      "largest_first_moment_norm_of_unmoved": moment}))
    return 0


def _kind(name: str) -> str:
    """A leaf's name without its layer index: "attn.wq", "ln1", ..."""
    parts = name.split(".")
    return ".".join(parts[2:]) if parts[0] == "layers" else name


def _own(tree):
    if isinstance(tree, dict):
        return {k: _own(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_own(v) for v in tree]
    return tree.clone()


def _names(tree, prefix=""):
    """Leaf names in ``train.tree.leaves`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in _names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


if __name__ == "__main__":
    sys.exit(main())
