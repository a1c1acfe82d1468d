"""The quality evidence: does the port learn to transcribe?

Counterparts of the JAX package's scripts beside it, one module each, under
the script's own file name:

  * `synthetic_end_to_end`  the synthetic corpora (v1 sine tones, v2
    piano-shaped audio) and the learning check: a 128-channel x 8-layer
    twin of the flagship trained from scratch, then scored on held-out clips
    (`examples/synthetic_end_to_end.py`)
  * `make_synthetic_tree`   a MAPS-layout tree of v2 recordings for the CLI
    (`tools/make_synthetic_tree.py`)
  * `eval_inpainting`       F1 inside and outside a masked time or mel band
    (`tools/eval_inpainting.py`)
  * `eval_boundary`         butted against overlap-stitched windows on long
    recordings (`tools/eval_boundary.py`)
  * `eval_longform`         one multi-minute piece through `transcribe`
    (`tools/eval_longform.py`)
  * `bf16_drift`            a trained model's reverse process through the
    kernels against the plain version on f32 and on bf16-rounded weights

The renderers are numpy only and give the JAX scripts' bits. Training and
scoring run through the port's entries: K3 + K4 (or autograd) to train, K2
to sample. Each entry runs on the card unless it is given `device=cpu`, and
exits on `device=cuda` without one.
"""
