"""`python -m diffroll_tpu_torch <command> key=value ...`

Commands:
  transcribe  a folder of audio files -> piano rolls + MIDI
              (pretrained_path=<file.ckpt> dataset.audio_path=<dir> device=cuda|cpu)
  train       fit a model on MAPS / MAESTRO ([spec_roll|unsupervised_pretrained]
              dataset.root=<dir> task.fused_train=true device=cuda|cpu)

The JAX package's other entries (test, sample, infer, sweep, distill,
serve) are ROADMAP items of the port.
"""

from __future__ import annotations

import sys


def _dispatch(argv) -> int:
    from .cli import train, transcribe

    commands = {"transcribe": transcribe.main, "train": train.main}
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in commands:
        print(__doc__)
        return 0 if argv and argv[0] in ("-h", "--help") else 2
    commands[argv[0]](list(argv[1:]))
    return 0


if __name__ == "__main__":
    sys.exit(_dispatch(sys.argv[1:]))
