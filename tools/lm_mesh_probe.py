"""The LM mesh on four cards (NCCL, one rank a card) against one card.

    python3 tools/lm_mesh_probe.py

Three arms, each held against a one-card run of the same inputs made
first in this process on card 0:

* qwen2-7b (bf16, the attention kernel) prefill of 64 prompts of 512
  tokens into a 32768-position state, then 8 greedy decode steps, on a
  (2, 2) ("data", "model") mesh: 64 rows hold ~60 GB of K/V, more than one
  card takes with the weights. Its first 16 rows against the one-card
  batch-16 run of the same prompts: the prefill's last logits within
  ``chip_smoke.DECODE_BF16_X`` times the bf16 depth floor (phase 18's: the
  largest distance of the one-card bf16 logits from the same weights' f32
  prefill; the bf16 products add in another order, and the row-parallel
  partial sums round once more, when the model axis splits them), the
  first greedy token on every row whose top-2 margin exceeds twice the
  floor, and the later tokens reported;
* the split-K decode: one prompt on a (4, 1) mesh, the KV positions split
  over the 4 ranks, 8 steps against the one-card batch-1 run: the tokens;
* a SmolLM-135M train step (8 x 1024, bf16) on (2, 2) against one card:
  the loss within LOSS_REL, and the largest parameter change's difference.

It prints every arm's readings with the cards' name and power limit, then
fails if any check failed. Needs
four cards. ``--host`` rehearses it on the CPU: four gloo ranks, the
reduced configs in bf16, small shapes.
"""
from __future__ import annotations

import dataclasses
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

B, P, CHECK_ROWS, STEPS, CONTEXT = 64, 512, 16, 8, cs.DECODE_CONTEXT
TRAIN = (8, 1024)
#: the host rehearsal's (``--host``): devices, backend, config size
HOST = {"device": "cuda", "backend": "nccl", "reduced": False}
#: a bf16 loss: the order of the bf16 products' sums moves it by a few
#: bf16 roundings
LOSS_REL = 1e-2


def _qwen():
    from repro_torch import configs

    if HOST["reduced"]:
        return dataclasses.replace(configs.get("qwen2_7b", reduced=True),
                                   dtype="bfloat16", scan_layers=True)
    return dataclasses.replace(configs.get("qwen2_7b"), attn_impl="pallas")


def _prompts(cfg, n: int) -> np.ndarray:
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P)).astype(
        np.int32)[:n]


def _decode(cfg, dev, toks, mesh=None, floor=False):
    """Prefill + STEPS greedy steps (``chip_smoke._lm_serve``)."""
    return cs._lm_serve(cfg, dev, toks, CONTEXT, STEPS, mesh=mesh,
                        floor=floor)


def _train(dev, mesh=None):
    """One SmolLM-135M train step (``chip_smoke._lm_train``): (loss, the
    parameters before and after, on the host)."""
    from repro_torch import configs

    return cs._lm_train(configs.get("smollm_135m", reduced=HOST["reduced"]),
                        dev, TRAIN, mesh)


def _rank(rank: int, world: int, facts: str, host: bool) -> dict:
    from repro_torch.launch.mesh import device_mesh

    if host:   # a spawned rank imports this module afresh
        _host_rehearsal()
    dev = torch.device("cuda", rank) if HOST["device"] == "cuda" \
        else torch.device("cpu")
    m22 = device_mesh((2, 2), ("data", "model"))
    m41 = device_mesh((4, 1), ("data", "model"))
    cfg = _qwen()
    big = _decode(cfg, dev, _prompts(cfg, B), mesh=m22)
    one = _decode(cfg, dev, _prompts(cfg, 1), mesh=m41)
    loss, before, after = _train(dev, mesh=m22)
    if rank:
        return {}
    np_ = lambda x: x.numpy() if isinstance(x, torch.Tensor) else x  # noqa: E731,E501
    return {"big": tuple(map(np_, big)), "one": tuple(map(np_, one)),
            "train": (loss, [np_(t) for t in before],
                      [np_(t) for t in after])}


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _host_rehearsal() -> None:
    """``--host``: the CPU, gloo, the reduced configs, small shapes."""
    global B, P, CHECK_ROWS, STEPS, CONTEXT, TRAIN
    HOST.update(device="cpu", backend="gloo", reduced=True)
    B, P, CHECK_ROWS, STEPS, CONTEXT, TRAIN = 8, 16, 4, 3, 64, (4, 32)
    torch.cuda.synchronize = lambda *a, **k: None
    cs._free = lambda: None


def main(argv: list[str]) -> int:
    if "--host" in argv:
        _host_rehearsal()
        facts = "host rehearsal"
        dev = torch.device("cpu")
    else:
        facts = cs._gpu_facts()
        n = torch.cuda.device_count()
        print(f"{n} card(s): {torch.cuda.get_device_name(0)}, torch "
              f"{torch.__version__}, NCCL "
              f"{'.'.join(map(str, torch.cuda.nccl.version()))} [{facts}]",
              flush=True)
        if n < 4:
            print("lm_mesh_probe: needs four cards", file=sys.stderr)
            return 2
        cs._kernel_mods()["flash_attention"]._launcher()
        dev = torch.device("cuda", 0)
    cfg = _qwen()
    t0 = time.perf_counter()
    base16 = _decode(cfg, dev, _prompts(cfg, CHECK_ROWS), floor=True)
    floor = base16[5]
    base1 = _decode(cfg, dev, _prompts(cfg, 1))
    tloss, tbefore, tafter = _train(dev)
    print(f"  one card: qwen2-7b batch {CHECK_ROWS} prefill "
          f"{base16[2]:.3f} ms, step {base16[3]:.3f} ms; batch 1 step "
          f"{base1[3]:.3f} ms; the bf16 depth floor (bf16 vs f32 "
          f"prefill, max_abs) {floor:.4e}; smollm-135m step loss "
          f"{tloss:.6f} "
          f"({time.perf_counter() - t0:.1f} s) [{facts}]", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        (r0, *_) = cs._mesh_group(_rank, 4, HOST["backend"], Path(tmp),
                                  facts, "--host" in argv)
    t_ = lambda x: torch.from_numpy(x) if isinstance(x, np.ndarray) else x  # noqa: E731,E501
    r0 = {"big": tuple(map(t_, r0["big"])), "one": tuple(map(t_, r0["one"])),
          "train": (r0["train"][0], [t_(x) for x in r0["train"][1]],
                    [t_(x) for x in r0["train"][2]])}
    fails = []
    logits, toks, pre_ms, step_ms, split, _ = r0["big"]
    rel = _rel(logits[:CHECK_ROWS], base16[0])
    err = float((logits[:CHECK_ROWS] - base16[0]).abs().max())
    top2 = base16[0].topk(2, dim=-1).values
    robust = (top2[:, 0] - top2[:, 1]) > 2 * floor
    first = toks[:CHECK_ROWS, 0] == base16[1][:, 0]
    same = (toks[:CHECK_ROWS] == base16[1]).all(dim=1)
    print(f"  (2, 2) qwen2-7b batch {B} x {P} into {CONTEXT} "
          f"positions: prefill {pre_ms:.3f} ms ({B * P / pre_ms * 1e3:.1f} "
          f"tokens/s), decode step median {step_ms:.3f} ms "
          f"({B / step_ms * 1e3:.1f} tokens/s); first {CHECK_ROWS} rows' "
          f"last logits from one card's: max_abs {err:.4e} "
          f"({err / floor:.3f} of the floor, limit {cs.DECODE_BF16_X}), "
          f"{rel:.3e} of their norm; first token equal on "
          f"{int(first.sum())} of {CHECK_ROWS} rows ({int(robust.sum())} "
          f"past the margin, all required); all {1 + STEPS} tokens equal on "
          f"{int(same.sum())} rows [{facts}]", flush=True)
    if not err <= cs.DECODE_BF16_X * floor:
        fails.append(f"(2, 2) logits {err} from one card's, floor {floor}")
    if not bool(first[robust].all()):
        fails.append(f"(2, 2) first tokens {first.tolist()} on robust rows "
                     f"{robust.tolist()}")
    l1, t1, _, s1, split1, _ = r0["one"]
    print(f"  (4, 1) split-K (split_k={split1}) qwen2-7b batch 1: tokens "
          f"{t1.flatten().tolist()} vs one card {base1[1].flatten().tolist()};"
          f" last logits at {_rel(l1, base1[0]):.3e}; step median "
          f"{s1:.3f} vs {base1[3]:.3f} ms on one card [{facts}]", flush=True)
    if not split1 or not torch.equal(t1, base1[1]):
        fails.append("(4, 1) split-K tokens differ from one card")
    loss, before, after = r0["train"]
    drift = max(float(((a - b) - (c - d)).abs().max()) for a, b, c, d in
                zip(after, before, tafter, tbefore))
    moved = max(float((c - d).abs().max()) for c, d in zip(tafter, tbefore))
    print(f"  (2, 2) smollm-135m train step {TRAIN[0]} x {TRAIN[1]}: loss "
          f"{loss:.6f} vs {tloss:.6f} on one card "
          f"({abs(loss - tloss) / tloss:.3e}); the largest update "
          f"{moved:.3e}, its largest difference from one card's "
          f"{drift:.3e} [{facts}]", flush=True)
    if not abs(loss - tloss) < LOSS_REL * tloss:
        fails.append(f"(2, 2) train loss {loss} vs {tloss}")
    if fails:
        raise AssertionError("; ".join(fails))
    print(facts)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
