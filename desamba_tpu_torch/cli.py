"""Command line of the port: ``classify`` on the device pipeline.

    python -m desamba_tpu_torch.cli classify <index_dir> <reads.fq> \\
        -o out.sam [--device cuda]

It takes the options of ``desamba-tpu classify`` (desamba_tpu/cli.py),
whose ``--engine auto`` resolves, as there, to the engine that leads (the
gold oracle), plus ``--device``: the device path runs on the card
(``cuda``, the default) unless the caller asks for the CPU (``--device
cpu``, as the tests do).
"""
from __future__ import annotations

import argparse
import sys
import time


def cmd_classify(args):
    from .engine.device.classifier import DeviceClassifier
    from .engine.gold.classify import ClassifyEngine, Options
    from .index.store import load_index
    from .io.fastx import read_fastx_fast as read_fastx
    from .io.sam import format_result

    idx = load_index(args.index_dir)
    print("loading index\tStart classify", file=sys.stderr)
    opts = Options(filter_min_length=args.l, max_sec_n=args.r,
                   filter_min_score=args.s, out_format=args.f)
    out = sys.stdout if args.o is None else open(args.o, "w")
    n = 0
    t1 = time.time()
    engine = args.engine
    if engine == "auto":
        # the gold oracle on one host thread still leads the device pass:
        # 9.111 s against 12.510 s for chip_smoke.py's 4,096 reads (32
        # Mbases; NVIDIA H100 80GB HBM3, 700.00 W); flips to the device
        # engine when it takes the lead
        engine = "gold"
    if engine == "gold":
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
                    help="device = this package's device pipeline; gold "
                         "= the host oracle; auto = the faster of the two "
                         "(gold, for now)")
    pc.add_argument("--device", default="cuda",
                    help="torch device of the device pipeline (default "
                         "cuda; cpu for tests)")
    pc.set_defaults(fn=cmd_classify)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
