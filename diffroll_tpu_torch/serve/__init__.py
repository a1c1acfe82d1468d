"""Serving: a persistent transcription service with cross-request
micro-batching (counterpart of `diffroll_tpu/serve/`).

  * The model loads once and stays on its device; every sampler batch has
    the same shape (`max_batch` windows, zero-padded), so on a card the
    whole-process sampler (K2) always runs at one batch size.
  * Requests of any length become hop-aligned 640-frame windows
    (tasks/transcribe.py). One dispatcher thread gathers windows from
    concurrent requests into a batch (up to `max_batch`, waiting at most
    `max_wait_ms` after the first), so a lone request sees one batch's
    latency and a busy service the card's batched rate.
  * Issue and completion are two threads, `pipeline_depth` batches deep: the
    dispatcher issues batch k+1 on the service's CUDA stream while the card
    still computes batch k; the completion thread waits on each batch's
    event, copies the rolls to the host and delivers them.
  * Results stitch back per request (a linear cross-fade in the window
    overlaps) and decode to note events or MIDI on the request's thread.

HTTP (the standard library's ThreadingHTTPServer):
  POST /transcribe   body = WAV bytes -> JSON {notes, frames, placement, ...},
                     placement: each window's [batch ordinal, row]
                     ?midi=1 -> a MIDI file instead
                     ?roll=1 -> the stitched roll too, bit for bit:
                     {dtype, shape, data: base64 of its little-endian bytes}
                     ?threshold=0.5 overrides the frame threshold
  GET  /healthz      liveness, counters and model info
"""

from .service import ServiceOverloaded, TranscriptionService, serve_forever

__all__ = ["TranscriptionService", "ServiceOverloaded", "serve_forever"]
