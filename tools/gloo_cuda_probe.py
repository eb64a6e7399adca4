#!/usr/bin/env python3
"""Which ``torch.distributed`` calls the gloo backend runs on CUDA tensors.

    python3 tools/gloo_cuda_probe.py [--device cuda] [--ranks 2]

For each call (all_reduce, all_gather, broadcast, and a send/recv pair
through ``batch_isend_irecv``) it spawns ``--ranks`` gloo ranks on the one
card (``cuda:0``) in a fresh process group and makes the call once with a
small CUDA tensor.  A call can succeed (the result is checked), raise, or
end the rank processes (gloo hands the device pointer to the socket, which
the kernel refuses with EFAULT, and gloo aborts): each call runs in ranks
of its own so that one abort does not hide the others.  Prints one line a
call and a JSON line {call: "ok" | "raises" | "aborts" | "wrong"}; the
port's ``parallel.collectives.GLOO_HOST_STAGED`` stages the calls that do
not take CUDA tensors through the host.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CALLS = ("all_reduce", "all_gather", "broadcast", "send_recv")


def one_call(rank, world, device, call):
    """One rank: the call on a CUDA tensor, its result checked."""
    import torch
    import torch.distributed as dist
    x = torch.full((1024,), float(rank + 1), device=device)
    try:
        if call == "all_reduce":
            dist.all_reduce(x)
            ok = float(x[0]) == world * (world + 1) / 2
        elif call == "all_gather":
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x)
            ok = [float(p[0]) for p in parts] == [r + 1.0
                                                 for r in range(world)]
        elif call == "broadcast":
            dist.broadcast(x, src=0)
            ok = float(x[0]) == 1.0
        else:
            y = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
                   dist.P2POp(dist.irecv, y, (rank - 1) % world)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            ok = float(y[0]) == (rank - 1) % world + 1
        torch.cuda.synchronize()
        return "ok" if ok else "wrong"
    except (RuntimeError, ValueError, TypeError) as e:
        return f"raises: {str(e).splitlines()[0][:160]}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    from eddie_wang_hackathon2023_tpu_torch.parallel import spawn_ranks
    print(f"torch {torch.__version__}, gloo, {args.ranks} ranks on "
          f"{args.device}")
    found = {}
    for call in CALLS:
        try:
            res = spawn_ranks(one_call, args.ranks, call, backend="gloo",
                              device=args.device, timeout=120)
            verdict = ("ok" if all(r == "ok" for r in res) else
                       "raises" if any(r.startswith("raises") for r in res)
                       else "wrong")
            detail = res
        except RuntimeError as e:
            verdict, detail = "aborts", str(e).splitlines()[1:3]
        found[call] = verdict
        print(f"{call}: {verdict} ({detail})")
    print(json.dumps(found))
    return 0


if __name__ == "__main__":
    sys.exit(main())
