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

and the runners of the JAX package's recorded experiments, each chaining
the port's CLI entries in one process:

  * `paper_sweeps`          F1 over spec dropout p and over guidance w, and
    inpainting on the p = 0.1 model (`results/{psweep,wsweep,inpainting}_synthetic_v2`)
  * `pretrain_both_pipeline` unconditional pretraining, the dual-loss retrain,
    a w-sweep and guided distillation (`tools/pretrain_both_pipeline.sh`)
  * `fullsize_distill`      the full-width flagship trained, distilled and
    scored at five operating points (`results/fullsize_distill_tpu/*.sh`)

The renderers are numpy only and give the JAX scripts' bits. Training and
scoring run through the port's entries: K3 + K4 (or autograd) to train, K2
to sample. Each entry runs on the card unless it is given `device=cpu`, and
exits on `device=cuda` without one.
"""
