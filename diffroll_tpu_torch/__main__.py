"""`python -m diffroll_tpu_torch <command> key=value ...`

Commands:
  transcribe  a folder of audio files -> piano rolls + MIDI
              (pretrained_path=<file.ckpt> dataset.audio_path=<dir> device=cuda|cpu)
  train       fit a model on MAPS / MAESTRO, then score the test split
              ([spec_roll|unsupervised_pretrained|pianoroll|baseline]
              dataset.root=<dir> model_name=<preset> task.fused_train=true
              device=cuda|cpu); every model preset trains: the U-Nets
              (pianoroll, model_name=SpecUnet), DiffRollv2 and
              model.condition=trainable_spec|trainable_z
  test        full reverse diffusion over the test split + frame / note F1
              (pretrained_path=<file.ckpt> dataset.root=<dir>)
  sample      transcription, inpainting or generation with the trajectory
              (pretrained_path=<file.ckpt> task.sampling_type=... num_samples=N)
  sweep       a w x threshold grid over one checkpoint (w_grid=[...]
              threshold_grid=[...]), or one train + test run per spec dropout
              (p_grid=[...])
  serve       an HTTP transcription service with micro-batching
              (pretrained_path=<file.ckpt> serve.port=8077 serve.max_batch=8)
  distill     progressive distillation of a checkpoint's sampler into few-step
              students (pretrained_path=<file.ckpt> dataset.root=<dir>
              distill.start_steps=65 distill.stages=5 task.fused_train=true)
  infer       unconditional rolls from noise with a U-Net checkpoint
              (pretrained_path=<file.ckpt> num_samples=N), written as npz
              with the trajectory and as MIDI

Every command takes `config=<file>.yaml` (its keys layered under the CLI's).
Under `torchrun --nproc_per_node=N -m diffroll_tpu_torch <command> ...`
train, distill, test, sweep, transcribe and serve run over N ranks (the
(data, model) mesh: `trainer.model_axis=M` ranks share each parameter in
train, distill and serve, N / M data stripes); the group they start is
closed when the command ends.
"""

from __future__ import annotations

import sys


def _dispatch(argv) -> int:
    from .cli import distill, infer, sample, serve, sweep, test, train, transcribe

    commands = {"transcribe": transcribe.main, "train": train.main, "test": test.main,
                "sample": sample.main, "sweep": sweep.main, "serve": serve.main,
                "distill": distill.main, "infer": infer.main}
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in commands:
        print(__doc__)
        return 0 if argv and argv[0] in ("-h", "--help") else 2
    from .parallel.mesh import close_group

    try:
        commands[argv[0]](list(argv[1:]))
    finally:
        close_group()
    return 0


if __name__ == "__main__":
    sys.exit(_dispatch(sys.argv[1:]))
