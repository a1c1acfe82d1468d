"""Serving entry: a persistent transcription HTTP service (counterpart of
`diffroll_tpu/cli/serve.py`).

    python -m diffroll_tpu_torch serve pretrained_path=<file.ckpt> \
        serve.port=8077 serve.max_batch=8 task.sampling_steps=50 device=cuda

POST WAV bytes to /transcribe (-> JSON note events; ?midi=1 for a MIDI
file), GET /healthz for liveness. Windows from concurrent requests are
micro-batched into one sampler batch shape (diffroll_tpu_torch/serve/).

Over several cards, one process a card:

    torchrun --nproc_per_node=2 -m diffroll_tpu_torch serve \
        pretrained_path=<file.ckpt> serve.max_batch=8

rank 0 answers HTTP and each batch's windows are striped over the data
axis (`max_batch` rounded down to a multiple of it); with
`trainer.model_axis=M` each rank keeps its chunk of the weights and the
sampler reads them whole, gathered once.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

from ..config import from_argv
from . import _common


def make_service(argv: List[str]):
    """The warmed-up service and its config and info, as `main` serves them.
    Over a mesh, rank 0's is warmed up once the other ranks `follow`."""
    cfg, _, overrides = from_argv(argv, "sampling")
    mesh, device = _common.setup_mesh(cfg)
    cfg, model, task, _ = _common.load_pretrained(cfg, overrides=overrides, device=device)
    _common.shard_model(model, mesh)

    # the service is self-contained: the sampler identity and grid that a
    # checkpoint the port trained recorded win over the preset (a distilled
    # student must run its own grid), explicit task.* keys over both; w and
    # the threshold stay with the serving preset. (A published Lightning
    # checkpoint's recorded sampler is adopted by load_pretrained.)
    stored_task = _common.stored_task_config(cfg.pretrained_path)
    if stored_task is not None:
        adopted = {key: getattr(stored_task, key) for key in ("sampling_type", "sampling_steps")
                   if f"task.{key}" not in overrides}
        if adopted:
            cfg = cfg.replace(task=cfg.task.replace(**adopted))
            task = type(task)(model, cfg.task)

    from ..serve import TranscriptionService

    sv = cfg.serve
    service = TranscriptionService(
        task, max_batch=sv.max_batch, max_wait_ms=sv.max_wait_ms,
        overlap_frames=sv.overlap_frames, max_body_mb=sv.max_body_mb,
        frame_threshold=_common.task_threshold(cfg), seed=cfg.trainer.seed,
        transfer_dtype=sv.transfer, pipeline_depth=sv.pipeline_depth, mesh=mesh)
    if service.leads:   # the other ranks take part in the warm-up in `follow`
        print("warming up the sampler...", file=sys.stderr)
        service.warmup()
    info = {"model": cfg.model_name, "sampler": cfg.task.sampling_type,
            "steps": cfg.task.sampling_steps or cfg.task.timesteps,
            "max_batch": service.max_batch, "device": str(model.device)}
    return service, cfg, info


def main(argv: Optional[List[str]] = None):
    from ..serve import serve_forever

    service, cfg, info = make_service(sys.argv[1:] if argv is None else argv)
    if not service.leads:
        service.follow()   # until rank 0 stops
        return
    sv = cfg.serve
    print(json.dumps({"serving": f"http://{sv.host}:{sv.port}", **info}),
          file=sys.stderr, flush=True)
    try:
        serve_forever(service, sv.host, sv.port, info=info)
    finally:
        service.close()


if __name__ == "__main__":
    main()
