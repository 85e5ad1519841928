"""One process of a multi-process classify run.

    python -m desamba_tpu_torch.tools.multihost_worker \\
        --coordinator HOST:PORT --num-processes P --process-id K \\
        --index DIR --reads READS.fq --out OUT.sam \\
        [--device cuda|cpu] [--local-devices N] [--n-idx I]

Counterpart of ``tools/multihost_worker.py``: ``dp`` (reads) spans the
processes, which exchange only the input split and the ordered result
gather, while each process classifies on its own devices
(``parallel.distributed``). Every process runs the same program:

  1. ``distributed.initialize`` (NCCL for ``--device cuda``, gloo for
     ``cpu``);
  2. ``host_mesh`` over every process's devices, checked to keep ``idx``
     inside one process, and an ``all_reduce`` of the processes' read
     counts, which must add up to the stream's;
  3. process k classifies the contiguous slice
     [k * ceil(n / P), (k + 1) * ceil(n / P)) with a ``MeshClassifier``
     on a (N / I, I) mesh of its own devices (``--device cpu`` repeats the
     CPU N times);
  4. an ordered gather of the SAM bytes; process 0 writes ``--out``.

The output equals one process's ``DeviceClassifier`` on the whole stream,
byte for byte. The only state that crosses reads is ``max_read_l``
(src/cly.h:157), and the classifier raises it only at a read whose finish
ran on chains (the device finish, ``post_finish_native`` and
``post_rescore_finish``; gold's ``_finish_rows``), and reads it only
through ``max(max_read_l, read_len) < 510`` (``post_rescore_finish``,
``csrc/rescorehot.c``). So a slice's output depends on its seed only
through the seed's side of 510. The JAX worker seeds each slice with the
longest read before it, chains or not; a chainless read of 510 bp or more
then puts the seed above 510 while one process's state stays below it,
and the next slice's short reads are filtered differently. Here each
slice starts from that guess, which is never below the serial state, and
``serial_walk`` then finds, slice by slice in order, the serial state's
side from what each run reports (its seed and its final state), and has
the owner re-run any slice whose guess fell on the other side.
"""
from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch
import torch.distributed as dist

# the one test of the stream state: max(max_read_l, read_len) < 510
STATE_SPLIT = 510


def slice_bounds(n: int, num_processes: int, pid: int):
    """Process ``pid``'s contiguous share [lo, hi) of ``n`` reads."""
    per = math.ceil(n / num_processes)
    lo = min(n, pid * per)
    return lo, min(n, lo + per)


def comm_device(backend: str) -> torch.device:
    """The device a collective's tensors live on for ``backend``."""
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_count(n: int, device) -> int:
    """The sum over the processes of each one's ``n``."""
    t = torch.tensor([n], dtype=torch.int64, device=device)
    dist.all_reduce(t)
    return int(t.item())


def all_gather_ints(values, device) -> np.ndarray:
    """(processes, len(values)) int64: every process's ``values``."""
    t = torch.tensor(list(values), dtype=torch.int64, device=device)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def ordered_gather(blob: bytes, device) -> list:
    """Every process's ``blob``, in process order (an all-gather of the
    lengths, then of the blobs padded to the longest)."""
    lens = all_gather_ints([len(blob)], device)[:, 0]
    buf = torch.zeros(max(1, int(lens.max())), dtype=torch.uint8)
    if blob:
        buf[: len(blob)] = torch.frombuffer(bytearray(blob),
                                            dtype=torch.uint8)
    buf = buf.to(device)
    out = [torch.empty_like(buf) for _ in lens]
    dist.all_gather(out, buf)
    return [bytes(o.cpu().numpy()[: int(n)]) for o, n in zip(out, lens)]


def serial_walk(seeds, finals, rerun):
    """Walk the slices in order and make each one's output the serial
    run's. ``seeds[j]`` and ``finals[j]`` are slice j's seed and final
    state; ``rerun(j, seed)`` re-classifies slice j from ``seed`` and
    returns its final state. Returns [(slice, seed)] of the re-runs.

    ``lo`` is the largest state that an earlier slice is known to have
    raised it to: a run that ends above its seed raised it to its end, and
    one that does not raised it by no more than its seed. It never passes
    the serial state and lies on its side of STATE_SPLIT (a slice whose
    raise crossed the split ran from a seed below it, and so ended above
    its seed), so a re-run from it gives the serial run's output."""
    lo = 0
    redone = []
    for j, (seed, final) in enumerate(zip(seeds, finals)):
        if (seed >= STATE_SPLIT) != (lo >= STATE_SPLIT):
            seed = lo
            final = rerun(j, seed)
            redone.append((j, seed))
        if final > seed:
            lo = max(lo, final)
    return redone


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--index", required=True)
    ap.add_argument("--reads", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--local-devices", type=int, default=None,
                    help="devices of this process (default: every CUDA "
                         "device; --device cpu repeats the CPU)")
    ap.add_argument("--n-idx", type=int, default=1,
                    help="idx axis size within each process")
    args = ap.parse_args(argv)

    from ..engine.gold.classify import Options, StreamState
    from ..index.store import load_index
    from ..io.fastx import read_fastx
    from ..io.sam import format_result
    from ..parallel.classifier import MeshClassifier
    from ..parallel.distributed import global_devices, host_mesh, initialize
    from ..parallel.mesh import make_mesh

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("multihost_worker: no CUDA device is available")
        n_local = args.local_devices or torch.cuda.device_count()
        if n_local > torch.cuda.device_count():
            raise SystemExit(f"multihost_worker: {n_local} devices asked, "
                             f"{torch.cuda.device_count()} present")
        local = [torch.device("cuda", k) for k in range(n_local)]
        torch.cuda.set_device(local[0])
        backend = "nccl"
    else:
        local = [torch.device("cpu")] * (args.local_devices or 1)
        backend = "gloo"
    if not initialize(args.coordinator, args.num_processes, args.process_id,
                      backend=backend):
        raise SystemExit("multihost_worker: no coordinator")
    try:
        pid = dist.get_rank()
        dev = comm_device(backend)
        # the global mesh: idx never crosses a process
        gmesh = host_mesh(n_idx=args.n_idx, devices=global_devices(local))
        for row in gmesh.devices:
            if len({d.process_index for d in row}) != 1:
                raise RuntimeError("the idx axis crossed a process")

        recs = list(read_fastx(args.reads))
        lo, hi = slice_bounds(len(recs), args.num_processes, pid)
        my = recs[lo:hi]
        total = all_reduce_count(len(my), dev)
        if total != len(recs):
            raise RuntimeError(f"the processes hold {total} reads of "
                               f"{len(recs)}")

        idx = load_index(args.index)
        mesh = make_mesh(len(local) // args.n_idx, args.n_idx, devices=local)
        eng = MeshClassifier(idx, Options(), mesh=mesh)
        sam = [b""]

        def run(seed):
            eng.state = StreamState(seed)
            sam[0] = "".join(format_result(r, idx.ref_name, eng.opts)
                             for r in eng.classify_reads(my)).encode()
            return eng.state.max_read_l

        guess = max((len(r.seq) for r in recs[:lo]), default=0)
        final = run(guess)
        seeds, finals = all_gather_ints([guess, final], dev).T

        def rerun(j, seed):
            # every process walks, so that the broadcasts line up; slice
            # j's owner re-runs it
            t = torch.tensor([run(seed) if j == pid else 0],
                             dtype=torch.int64, device=dev)
            dist.broadcast(t, src=j)
            return int(t.item())

        redone = serial_walk([int(s) for s in seeds],
                             [int(f) for f in finals], rerun)
        blobs = ordered_gather(sam[0], dev)
        if pid == 0:
            with open(args.out, "wb") as f:
                for b in blobs:
                    f.write(b)
        print(f"proc {pid}: reads {lo}..{hi}, {len(sam[0])} bytes; slices "
              f"re-run from the serial state: {redone}; "
              f"fallback={eng.fallback_stats()}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
