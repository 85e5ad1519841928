"""Command line of the port: ``classify`` on the device pipeline.

    python -m desamba_tpu_torch.cli classify <index_dir> <reads.fq> \\
        -o out.sam --device cuda

It takes the options of ``desamba-tpu classify`` (desamba_tpu/cli.py)
plus ``--device``, which has no default: the device path runs where the
caller says, on the card (``cuda``) or, for tests, on the CPU.
"""
from __future__ import annotations

import argparse
import sys
import time


def cmd_classify(args):
    from desamba_tpu.engine.gold.classify import ClassifyEngine, Options
    from desamba_tpu.index.store import load_index
    from desamba_tpu.io.fastx import read_fastx_fast as read_fastx
    from desamba_tpu.io.sam import format_result

    from .engine.device.classifier import DeviceClassifier

    idx = load_index(args.index_dir)
    print("loading index\tStart classify", file=sys.stderr)
    opts = Options(filter_min_length=args.l, max_sec_n=args.r,
                   filter_min_score=args.s, out_format=args.f)
    out = sys.stdout if args.o is None else open(args.o, "w")
    n = 0
    t1 = time.time()
    if args.engine == "gold":
        eng = ClassifyEngine(idx, opts)
        for path in args.reads:
            for rec in read_fastx(path):
                out.write(format_result(
                    eng.classify_read(rec.name, rec.seq, rec.qual),
                    idx.ref_name, opts))
                n += 1
    else:
        eng = DeviceClassifier(idx, opts, args.device)
        for path in args.reads:
            print(f"Processing file: [{path}].", file=sys.stderr)
            for res in eng.classify_file(path):
                out.write(format_result(res, idx.ref_name, opts))
                n += 1
        print(f"fallback: {eng.fallback_stats()}", file=sys.stderr)
    dt = time.time() - t1
    print(f"{n} sequences processed in {dt:.3f}s "
          f"({n / 1e3 / (dt / 60):.1f} Kseq/m).", file=sys.stderr)
    if args.o is not None:
        out.close()


def main(argv=None):
    p = argparse.ArgumentParser(prog="desamba-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("classify", help="classify reads")
    pc.add_argument("index_dir")
    pc.add_argument("reads", nargs="+")
    pc.add_argument("-t", type=int, default=4,
                    help="threads (accepted for compatibility)")
    pc.add_argument("-l", type=int, default=170, help="min matching length")
    pc.add_argument("-r", type=int, default=5, help="max secondary output")
    pc.add_argument("-o", default=None, help="output file")
    pc.add_argument("-s", type=int, default=64, help="min score")
    pc.add_argument("-f", default="SAM",
                    choices=["SAM", "SAM_FULL", "DES", "DES_FULL"])
    pc.add_argument("--engine", default="device",
                    choices=["auto", "gold", "device"],
                    help="device (and auto) = this package's device "
                         "pipeline; gold = the host oracle")
    pc.add_argument("--device", required=True,
                    help="torch device of the device pipeline, e.g. cuda")
    pc.set_defaults(fn=cmd_classify)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
