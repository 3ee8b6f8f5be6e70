"""The training entry point (twin of ``repro/launch/train.py``).

Runs real steps on one card (or the CPU, asked for) with either the
standard allreduce trainer or the paper's ADMM-consensus trainer
(``--trainer admm``), on the synthetic token stream, with checkpoint and
resume.  The end-to-end example (``examples/train_lm_consensus.py``:
mamba2-130m, ``--trainer admm --mesh 4x2``, batch 8, seq 256) runs
through it unchanged.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --reduced --steps 200 --batch 8 --seq 256 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --trainer admm --mesh 4x2 --steps 8 --ckpt-dir ckpt

``--device`` defaults to the card (``cuda``) and raises without one.
The parameters are drawn from ``torch.Generator(device).manual_seed(
seed)``, as the serve CLI draws them, so they are not the reference's;
the batches are: the stream's keys and tokens equal the reference's bit
for bit (``data/synthetic.py``).

``--mesh DxM``: D is the replica count R of the consensus trainer (the
reference's ``data`` axis, a leading replica axis on the one card); M,
the reference's tensor-parallel ``model`` axis, has no meaning on one
card, is printed as unused, and the run computes exactly what ``Dx1``
computes.  Under allreduce the card holds the whole batch and the mesh
changes nothing.

Checkpoints hold the reference's tree (``convert.train_state_to_numpy``:
the same keys, tuple arities, leaf order, shapes and dtypes) through the
port's ``checkpoint.save_step``, so each package resumes the other's
files; a resume re-seats the leaves by the reference's leaf order and
casts each to the live leaf's dtype (``convert.restore_train_state_``).
Two reference behaviours are kept, not fixed (ROADMAP queue 3): a
resumed run's data key restarts at ``key(seed + 1)``, so it re-reads the
stream's first batches; and a run whose ``steps`` is a multiple of
``ckpt_every`` saves its last step twice.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import convert
from repro_torch import device as device_lib
from repro_torch.checkpoint import restore_latest, save_step
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.core.consensus import ConsensusConfig
from repro_torch.data.synthetic import token_batch
from repro_torch.net import prng
from repro_torch.train import steps as steps_lib


def _replicas(mesh: str, trainer: str):
    """The consensus replica count of ``--mesh DxM`` (None without a
    mesh), printing what one card leaves unused."""
    if not mesh:
        return None
    d, m = (int(x) for x in mesh.split("x"))
    if trainer == "admm":
        if m != 1:
            print(f"mesh {mesh}: the model axis ({m}) is unused on one card; "
                  f"computing {d}x1")
    else:
        print(f"mesh {mesh}: unused under allreduce (one card holds the "
              f"whole batch)")
    return d


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--trainer", default="allreduce",
                    choices=["allreduce", "admm"])
    ap.add_argument("--consensus-eta", type=float, default=0.05)
    ap.add_argument("--consensus-every", type=int, default=1)
    ap.add_argument("--mesh", default="",
                    help="'DxM' (e.g. 4x2): D consensus replicas on the "
                         "card; M is unused; empty = no replicas")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    dev = device_lib.resolve(args.device)
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    shape = InputShape("cli", args.seq, args.batch, "train")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    replicas = _replicas(args.mesh, args.trainer)

    if args.trainer == "admm":
        if replicas is None:
            raise SystemExit("--trainer admm needs --mesh DxM (data axis = "
                             "consensus ring)")
        ccfg = ConsensusConfig(eta=args.consensus_eta,
                               every=args.consensus_every)
        state = steps_lib.make_consensus_train_state(
            cfg, gen, replicas, shape, lr=args.lr, device=dev)
        step_fn = steps_lib.make_consensus_train_step(cfg, replicas, ccfg,
                                                      lr=args.lr)
    else:
        state = steps_lib.make_train_state(cfg, gen, shape, lr=args.lr,
                                           device=dev)
        step_fn = steps_lib.make_train_step(cfg, lr=args.lr)

    start = 0
    if args.ckpt_dir:
        s, restored = restore_latest(args.ckpt_dir)
        if restored is not None:
            state = convert.restore_train_state_(state, restored)
            start = s
            print(f"resumed from step {start}")
        del restored            # the file's bytes, as large as the state

    data_key = prng.key(args.seed + 1)
    t0 = time.time()
    for step in range(start, args.steps):
        data_key, sub = prng.split(data_key)
        batch = token_batch(sub, cfg.vocab_size, args.batch, args.seq,
                            device=dev)
        state, metrics = step_fn(state, batch)
        if (step + 1) % args.log_every == 0 or step == start:
            # the reference's jitted step returns its metrics keys sorted
            m = {k: float(metrics[k]) for k in sorted(metrics)}
            rate = (step + 1 - start) * args.batch * args.seq / \
                (time.time() - t0)
            print(f"step {step+1:5d} " +
                  " ".join(f"{k}={v:.4f}" for k, v in m.items()) +
                  f" tok/s={rate:.0f}", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_step(args.ckpt_dir, step + 1,
                      convert.train_state_to_numpy(state))
    if args.ckpt_dir:
        save_step(args.ckpt_dir, args.steps,
                  convert.train_state_to_numpy(state))
    print("done")
    return state


if __name__ == "__main__":
    main()
