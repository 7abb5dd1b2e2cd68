"""Top-level command dispatcher.

  python -m syllable_detector_tpu detect  ...   (cli.py — offline detection)
  python -m syllable_detector_tpu train   ...   (train.py)
  python -m syllable_detector_tpu sim     ...   (sim.py)
  python -m syllable_detector_tpu monitor ...   (monitor.py)
"""

import sys

COMMANDS = {
    "detect": ("syllable_detector_tpu.cli", "offline detection CLI"),
    "train": ("syllable_detector_tpu.train", "train a detector from labeled audio"),
    "sim": ("syllable_detector_tpu.sim", "render a detection-signal WAV"),
    "monitor": ("syllable_detector_tpu.monitor", "live multi-channel monitor"),
    "inspect": ("syllable_detector_tpu.inspect_net", "summarize a network file"),
    "dist-scan": (
        "syllable_detector_tpu.dist_scan",
        "multi-host corpus scan (jax.distributed, sharded file list)",
    ),
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print("usage: python -m syllable_detector_tpu COMMAND ...\n\ncommands:")
        for name, (_, desc) in COMMANDS.items():
            print(f"  {name:8s} {desc}")
        return 0 if argv and argv[0] in ("-h", "--help") else 2

    import importlib

    module = importlib.import_module(COMMANDS[argv[0]][0])
    return module.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
