"""Multi-host (multi-process) corpus scan — the process-sharded deployment shape.

The reference is single-process (SURVEY §5: its only communication backend is
an in-process ring buffer + GCD queues); the multi-process equivalent for
batch corpus scans is: initialize ``jax.distributed`` across hosts, shard the FILE
LIST over processes (channels/files are embarrassingly parallel, so the only
cross-host traffic is control + final aggregation), scan each shard
with the batched device path, and reduce global detection counts with a
cross-process collective before process 0 merges the per-shard CSVs.

Usage (run the same command on every host):

  python -m syllable_detector_tpu.dist_scan \
      --coordinator HOST0:9876 --num-processes N --process-id I \
      -n NET.txt -a A.wav -a B.wav ... -o OUT_DIR [--platform cpu]

Process i writes ``OUT_DIR/shard{i}.csv``; process 0 waits for every shard
(via the collective barrier) and merges them into ``OUT_DIR/merged.csv`` in
the original file order. CPU-testable with two local processes
(tests/test_distributed.py).

One process per card: a JAX process reserves most of a GPU's memory when
it first touches it, so on a host with several cards give each process its
own (``CUDA_VISIBLE_DEVICES=I``), or run one process that drives them all
through ``cli --batched --mesh``.
"""

from __future__ import annotations

import argparse
import os
import sys

__all__ = ["shard_paths", "main"]


def shard_paths(paths, process_id: int, num_processes: int):
    """Deterministic contiguous partition of the corpus file list.

    Contiguous (not round-robin) so each shard's CSV concatenation preserves
    the CLI's file order when merged by shard index.
    """
    n = len(paths)
    lo = (n * process_id) // num_processes
    hi = (n * (process_id + 1)) // num_processes
    return list(paths)[lo:hi]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="syllable-detector-dist-scan",
        epilog="Needs one card per process: on a multi-GPU host set "
        "CUDA_VISIBLE_DEVICES per process.",
    )
    p.add_argument("--coordinator", required=True,
                   help="host:port of process 0's coordination service.")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("-n", "--net", action="append", required=True,
                   help="Network file; repeat to give each audio channel "
                   "its own network (cycled per channel).")
    p.add_argument("-a", "--audio", action="append", default=[],
                   help="Corpus file (repeatable); the FULL list, identical "
                   "on every process — sharding is internal.")
    p.add_argument("-o", "--out", required=True, help="Shared output dir.")
    p.add_argument("-d", "--debounce", type=float, default=None)
    p.add_argument("--method", choices=("matmul", "rfft"),
                   default="matmul")
    p.add_argument("--batch-files", type=int, default=None, metavar="N",
                   help="Scan each shard in groups of N files "
                   "(bounds memory on huge corpora).")
    p.add_argument("--platform", default=None,
                   help="Force a jax platform (e.g. cpu) before init.")
    args = p.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from syllable_detector_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    # the cross-process backend: a distributed runtime service on
    # process 0, GRPC handshake from everyone else
    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )

    from syllable_detector_tpu.config.model_format import ConfigError, load_config
    from syllable_detector_tpu.corpus import scan_corpus_files

    try:
        cfgs = [load_config(n) for n in args.net]
    except ConfigError as e:
        print(f"Unable to load the network configuration: {e}", file=sys.stderr)
        return 1
    cfg = cfgs if len(cfgs) > 1 else cfgs[0]

    mine = shard_paths(args.audio, args.process_id, args.num_processes)
    os.makedirs(args.out, exist_ok=True)
    shard_file = os.path.join(args.out, f"shard{args.process_id}.csv")

    import re

    lines: list[str] = []
    n_detections = 0
    # detection rows are "channel,sample,..."; header lines are raw paths
    # (which may themselves contain commas)
    _row = re.compile(r"^\d+,\d+,")

    def emit(s: str) -> None:
        nonlocal n_detections
        lines.append(s)
        if _row.match(s):
            n_detections += 1

    if mine:
        # headers on every file so the merged CSV keeps the multi-file
        # contract even when a shard holds a single file
        scan_corpus_files(
            cfg, mine, debounce_seconds=args.debounce, emit=emit,
            method=args.method, headers=len(args.audio) > 1,
            group_files=args.batch_files,
        )
    tmp = shard_file + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    os.replace(tmp, shard_file)  # atomic: merge never sees partial shards

    # global detection count (psum across processes) — doubles as
    # the barrier guaranteeing every shard file is on disk before the merge
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    counts = multihost_utils.process_allgather(
        jnp.asarray([n_detections], jnp.int32)
    ).reshape(-1)
    total = int(counts.sum())
    print(
        f"process {args.process_id}/{args.num_processes}: "
        f"{len(mine)} files, {n_detections} detections "
        f"(global {total})",
        file=sys.stderr,
    )

    if args.process_id == 0:
        merged = os.path.join(args.out, "merged.csv")
        with open(merged, "w") as out_f:
            for i in range(args.num_processes):
                path = os.path.join(args.out, f"shard{i}.csv")
                with open(path) as f:
                    out_f.write(f.read())
        print(f"merged -> {merged}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
