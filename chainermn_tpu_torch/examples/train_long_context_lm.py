"""Long-context LM with sequence parallelism: the twin of the JAX
package's ``examples/train_long_context_lm.py``.

    python -m chainermn_tpu_torch.examples.train_long_context_lm --device cpu
    torchrun --nproc_per_node=2 -m chainermn_tpu_torch.examples.train_long_context_lm --device cpu --sp-mode zigzag

The sequence axis is sharded over the ranks of the world (``torchrun``'s,
or a world of one run plainly): each rank holds ``T / n`` tokens of every
row, attention runs as ring attention (``--sp-mode ring``, or the
balanced ``zigzag`` schedule, for which the tokens and targets are
zigzag-sharded first) or Ulysses (``--sp-mode ulysses``), and the other
ops stay position-local.  Each step is SGD(lr=1e-3) on the gradient
averaged over the sequence ranks (``create_multi_node_optimizer``).
The flags are the JAX script's, with ``--device`` (``cuda``, the default,
or ``cpu``) for ``--platform`` and ``--simulate-devices``.  Rank 0 prints
``mode=... seq=... final_loss=... tokens/sec=...`` (the mean loss over
the ranks; the first step, the warm-up, is left out of the rate).
"""

import argparse
import time

import numpy as np
import torch

from .. import create_communicator, create_multi_node_optimizer
from ..core.optimizer import SGD
from ..models import TransformerLM
from ..parallel import zigzag_shard


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="chainermn_tpu_torch: long-context LM")
    parser.add_argument("--seq-len", type=int, default=1024,
                        help="global sequence length")
    parser.add_argument("--batchsize", "-b", type=int, default=2)
    parser.add_argument("--d-model", type=int, default=128)
    parser.add_argument("--n-heads", type=int, default=8)
    parser.add_argument("--n-layers", type=int, default=2)
    parser.add_argument("--vocab", type=int, default=256)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--sp-mode", choices=["ring", "zigzag", "ulysses"],
                        default="ring",
                        help="'zigzag' = causally balanced ring schedule "
                             "(inputs are zigzag-sharded along T)")
    parser.add_argument("--remat", default=None,
                        help="per-block rematerialization: 'full' (save "
                             "nothing) or 'dots' (keep the GEMM outputs)")
    parser.add_argument("--device", default="cuda",
                        help="where this rank's model runs: cuda (the "
                             "default; NCCL, fails without a card) or cpu "
                             "(gloo)")
    return parser.parse_args(argv)


def local_batch(args, comm):
    """This rank's ``(x, t)``: the seeded ``[B, T]`` tokens and their
    next-token targets, zigzag-ordered for ``--sp-mode zigzag``, cut to
    this rank's ``T / n`` slice."""
    n = comm.size
    if args.seq_len % n:
        raise SystemExit(f"--seq-len must be divisible by {n}")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, args.vocab,
                                     (args.batchsize, args.seq_len)))
    t = torch.roll(x, -1, dims=1)
    if args.sp_mode == "zigzag":
        if args.seq_len % (2 * n):
            raise SystemExit(f"--seq-len must be divisible by {2 * n} "
                             "for zigzag")
        x, t = zigzag_shard(x, n, axis=1), zigzag_shard(t, n, axis=1)
    tl = args.seq_len // n
    cut = slice(comm.rank * tl, (comm.rank + 1) * tl)
    return x[:, cut].to(comm.device), t[:, cut].to(comm.device)


def run(args, comm):
    """Train ``args.steps`` steps on ``comm`` (every rank calls it);
    returns ``(line, final_loss)``, the mean loss over the ranks."""
    model = TransformerLM(args.vocab, d_model=args.d_model,
                          n_heads=args.n_heads, n_layers=args.n_layers,
                          max_len=args.seq_len, sp_comm=comm,
                          sp_mode=args.sp_mode, remat=args.remat or False,
                          device=comm.device)
    comm.bcast_data(model)
    opt = create_multi_node_optimizer(SGD(lr=1e-3), comm).setup(model)
    x, t = local_batch(args, comm)
    cuda = comm.device.type == "cuda"
    start = time.perf_counter()
    for i in range(args.steps):
        loss = opt.update(model, x, t)
        if i == 0:
            if cuda:
                torch.cuda.synchronize()
            start = time.perf_counter()   # leave the warm-up out
    loss = float(comm.allreduce(loss.detach(), op="mean"))
    dt = time.perf_counter() - start
    tokens = args.batchsize * args.seq_len * max(args.steps - 1, 1)
    return (f"mode={args.sp_mode} seq={args.seq_len} "
            f"final_loss={loss:.4f} tokens/sec={tokens / dt:,.0f}"), loss


def main(argv=None):
    args = parse_args(argv)
    comm = create_communicator("jax_ici", device=args.device)
    try:
        line, loss = run(args, comm)
        if comm.rank == 0:
            print(line, flush=True)
        return loss
    finally:
        comm.finalize()


if __name__ == "__main__":
    main()
