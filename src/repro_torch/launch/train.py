"""Training launcher of the port: the fault-tolerant train loop, on the card
unless told otherwise.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-every 50 \
        --inject-failure 120

    # full SmolLM-135M width (30 layers, bf16, f32 AdamW moments, remat)
    PYTHONPATH=src python -m repro_torch.launch.train --full --steps 60 \
        --ckpt-every 20 --inject-failure 30 --ckpt-dir /tmp/ck

    # off the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 6 --batch 2 --seq 16 --ckpt-every 2 --inject-failure 3

    # on an LM mesh of data x model ranks (one card a rank; gloo with
    # --device cpu)
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --data 2 --model-axis 2 --steps 6 --batch 4 --seq 16

Features exercised end to end (DESIGN.md §4), as in the reference's
``repro.launch.train``:
  * the train step built by ``distribution/steps.py::make_train_step``;
  * atomic async checkpointing + auto-resume (restart the command and it
    continues from the latest checkpoint; the reference's layout);
  * failure injection (--inject-failure N raises at step N once; the loop
    restores from the last checkpoint in-process — the restart drill);
  * straggler watch: steps slower than ``--straggler-factor`` × the running
    median are counted and logged.

Parameters are drawn from ``torch.Generator(device).manual_seed(0)``. A
step's time ends at a device sync (reading its loss). ``main`` returns the
run's summary: steps, the step it started from, the steps the drill resumed
at, each step's loss and time, stragglers.

``--data`` / ``--model-axis`` above 1 run the step SPMD on an LM mesh
(``launch.mesh.make_local_mesh(data, model)``) under ``torchrun`` (world =
data x model): NCCL with ``LOCAL_RANK``'s card, or gloo with ``--device
cpu`` (``distribution.sharding.init_from_env``). Every rank draws the same
parameters and batches and keeps its own blocks (FSDP+TP parameters and
moments, the batch over the data axis); checkpoints hold whole leaves
written by rank 0, so a run resumes onto another mesh; only rank 0 logs.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch


class InjectedFailure(RuntimeError):
    pass


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default="experiments/ckpt")
    ap.add_argument("--inject-failure", type=int, default=0,
                    help="raise a simulated failure at this step (once)")
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--data", type=int, default=1, help="data-axis size")
    ap.add_argument("--model-axis", type=int, default=1, help="model-axis size")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device of the model (default: the CUDA card; "
                         "'cpu' runs on the host)")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs.base import InputShape
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distribution import sharding as sh
    from repro_torch.distribution.steps import make_train_step
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.utils import resolve_device

    n_mesh = args.data * args.model_axis
    if n_mesh > 1:
        args.device = sh.init_from_env(args.device)
    device = resolve_device(args.device, "repro_torch.launch.train")
    mesh = make_local_mesh(args.data, args.model_axis) if n_mesh > 1 \
        else None
    log = print if sh.is_writer() else (lambda *a, **k: None)
    cfg = configs.get(args.arch, reduced=args.reduced)
    shape = InputShape("cli", args.seq, args.batch, "train")
    opt = adamw(lr=args.lr)
    store = CheckpointStore(Path(args.ckpt_dir) / configs.canonical(args.arch),
                            device=device)
    bundle = make_train_step(cfg, opt, shape, accum_steps=args.accum,
                             device=device, mesh=mesh)
    step_fn = bundle.fn
    place = (lambda tree, key: tree) if mesh is None else \
        (lambda tree, key: sh.distribute_tree(tree, bundle.meta[key], mesh))

    def fresh():
        params = init_params(cfg, torch.Generator(device).manual_seed(0),
                             args.seq)
        return place(params, "pspecs"), place(opt.init(params), "ospecs")

    def restore(skel):
        restored, at, _ = store.restore(
            skel, shardings=None if mesh is None else skel)
        return restored["params"], restored["opt"], at

    params, opt_state = fresh()

    start = 0
    if store.latest_step() is not None:
        params, opt_state, start = restore({"params": params,
                                            "opt": opt_state})
        log(f"[resume] restored step {start} from {store.dir}")

    injected = {"done": start >= args.inject_failure > 0}
    durations: list[float] = []
    losses: list[float] = []
    resumed_at: list[int] = []
    stragglers = 0
    loss = float("nan")
    t_train0 = time.perf_counter()
    step = start
    while step < args.steps:
        try:
            batch = place(make_batch(cfg, args.batch, args.seq, seed=step,
                                     device=device), "bspecs")
            t0 = time.perf_counter()
            if args.inject_failure and step == args.inject_failure and not injected["done"]:
                injected["done"] = True
                raise InjectedFailure(f"simulated worker loss at step {step}")
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["ce_loss"])  # waits for the device
            dt = time.perf_counter() - t0
            durations.append(dt)
            losses.append(loss)
            med = float(np.median(durations[-50:]))
            if len(durations) > 5 and dt > args.straggler_factor * med:
                stragglers += 1
                log(f"[straggler] step {step}: {dt:.2f}s vs median {med:.2f}s")
            step += 1
            if step % args.log_every == 0:
                log(f"step {step}: loss {loss:.4f} "
                      f"({dt*1000:.0f} ms/step)")
            if args.ckpt_every and step % args.ckpt_every == 0:
                store.save_async(step, {"params": params, "opt": opt_state})
        except InjectedFailure as e:
            log(f"[failure] {e} -> restoring latest checkpoint")
            store.wait()
            latest = store.latest_step()
            if latest is None:
                log("[failure] no checkpoint yet; restarting from step 0")
                params, opt_state = fresh()
                step = 0
            else:
                params, opt_state, step = restore({"params": params,
                                                   "opt": opt_state})
            resumed_at.append(step)
            log(f"[failure] resumed at step {step}")
    store.wait()
    store.save(step, {"params": params, "opt": opt_state})
    total = time.perf_counter() - t_train0
    log(f"done: {step} steps in {total:.1f}s "
          f"({1000*total/max(step-start,1):.0f} ms/step avg), "
          f"stragglers={stragglers}, final loss {loss:.4f}")
    return {"steps": step, "start": start, "resumed_at": resumed_at,
            "losses": losses, "step_s": durations, "stragglers": stragglers,
            "ckpt_dir": store.dir}


if __name__ == "__main__":
    main()
