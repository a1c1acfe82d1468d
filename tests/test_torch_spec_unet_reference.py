"""The port's SpecUnet against the benchmark's plain reference
(`bench_port/reference/spec_unet.py`) on the CPU, on the same seeded weights
(`bench_port/weights_unet.py`), at dim 8 and 32 frames, the rest as
published:

  * the log-mel (`spec_norm: "none"`), the forward, the `spec_roll` loss,
    every parameter's gradient and one Adam step;
  * the cell's check (`runners/train_unet.py`) through a whole run: the
    program passes; the bf16 control and a half batch each fail;
  * `counts/spec_unet.py`'s forward operations against `FlopCounterMode`'s
    count of the port's module, at this size and at the published widths;
  * the U-Net's spans and its `unet.attn_rows` counter, and the readers that
    put the card's time down to the spans.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from bench_port import port
from bench_port import run as bench
from bench_port import trace as bench_trace
from bench_port import trace_annotated, weights_unet
from bench_port.counts import spec_unet as counts
from bench_port.counts import unet_dwconvs, unet_norms
from bench_port.reference import diffroll as ref
from bench_port.reference import spec_unet as uref
from bench_port.runners import train_unet
from diffroll_tpu_torch.nn import unet
from diffroll_tpu_torch.tasks.diffusion import DiffusionTask
from diffroll_tpu_torch.train import TrainState, make_train_step

torch.set_num_threads(1)
WORKLOAD = "specunet-train"
B = 4


def _cfg(**over):
    cfg = bench.load_json(bench.HERE / "configs" / "SpecUnet.json")
    cfg.update(residual_channels=8, frames=32, **over)
    return cfg


def _mix():
    mix = bench.load_json(bench.HERE / "traffic" / "train_unet_b16.json")
    mix.update(batch=B, pool=5, trace_after=1, trace_steps=2)
    return mix


def _model(seed=7):
    cfg = _cfg()
    params = weights_unet.make(cfg, seed, torch.device("cpu"))
    return cfg, params, port.build_model(cfg, torch.device("cpu"), params)


def _batch(cfg, seed=3):
    g = torch.Generator().manual_seed(seed)
    return {"audio": 0.1 * torch.randn(B, cfg["frames"] * 512, generator=g),
            "frame": (torch.rand(B, cfg["frames"], 88, generator=g) < 0.08).float(),
            "t": torch.tensor([0, 17, 120, 199]),
            "noise": torch.randn(B, cfg["frames"], 88, generator=g)}


# ------------------------------------------------------------------ the rule

def test_the_weight_rule_sets_every_group_norm_scale_near_one():
    cfg, params, model = _model()
    names = weights_unet.norm_weights(cfg)
    assert len(names) == sum(isinstance(m, torch.nn.GroupNorm) for m in model.modules()) > 40
    scales = torch.cat([params[n] for n in names])
    assert (scales - 1).abs().max() < 0.3 and 0.03 < (scales - 1).std() < 0.07
    for k, v in model.state_dict().items():
        assert torch.equal(v, params[k]), k
    again = weights_unet.make(cfg, 7, torch.device("cpu"))
    assert all(torch.equal(again[k], v) for k, v in params.items())


# ------------------------------------------------------------------ parity

def test_conditioner():
    cfg, _, model = _model()
    wave = _batch(cfg)["audio"]
    torch.testing.assert_close(uref.conditioner(wave, cfg), model.conditioner(waveform=wave),
                               atol=2e-5, rtol=1e-4)


def test_forward():
    cfg, params, model = _model()
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, cfg["frames"], 88, generator=g)
    t = torch.tensor([0, 57, cfg["timesteps"] - 1])
    cond = torch.randn(3, cfg["frames"], cfg["n_mels"], generator=g) - 4.0
    with torch.no_grad():
        got = model.apply(x, t, cond)
        want = uref.SpecUnet(params, cfg)(x, t, cond)
    assert got.shape == (3, cfg["frames"], 88) and want.abs().max() > 0.1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def _port_step(cfg, params, batch):
    """The port's loss and gradients (before the step), and its parameters
    after one `make_train_step`."""
    model = port.build_model(cfg, torch.device("cpu"), params)
    task = port.build_task(cfg, model)
    state = TrainState.create(model, cfg["lr"])
    seen = {}

    def loss(b, generator, train):
        total, rest = task.loss_fn(b, generator, train, t=b["t"], noise=b["noise"])
        seen["loss"] = total.detach()
        return total, rest

    real_step = state.optimizer.step

    def step(closure=None):
        seen["grads"] = {f"net.{k}": (None if p.grad is None else p.grad.clone())
                         for k, p in model.net.named_parameters()}
        return real_step(closure)

    state.optimizer.step = step
    make_train_step(loss)(state, batch, None)
    return seen, {f"net.{k}": p.detach() for k, p in model.net.named_parameters()}


def test_loss_every_gradient_and_one_adam_step():
    cfg, params, _ = _model()
    batch = _batch(cfg)
    seen, after = _port_step(cfg, params, batch)

    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = uref.train_loss(uref.SpecUnet(leaves, cfg), cfg, batch["audio"], batch["frame"],
                           batch["t"], batch["noise"])
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = dict(zip(leaves, grads))
    torch.testing.assert_close(seen["loss"], loss.detach(), atol=0, rtol=1e-5)

    assert set(seen["grads"]) == set(grads)
    unused = {k for k, g in grads.items() if g is None}
    assert unused == {k for k, g in seen["grads"].items() if g is None}
    # the last block's spectrogram output is not used: its stream has no gradient
    assert unused and all(k.startswith("net.final_block.spec_net_") for k in unused)
    for k, g in grads.items():
        if g is not None:
            gap = float((seen["grads"][k] - g).norm() / g.norm())
            assert gap < 1e-4, (k, gap)

    # the step on the port's own gradients: an element whose gradient is near
    # Adam's eps moves by any amount its rounding decides
    want = {k: v.clone() for k, v in params.items()}
    with torch.no_grad():
        ref.adam_update(want, {k: g for k, g in seen["grads"].items() if g is not None}, {}, 1,
                        cfg["lr"])
    for k in params:   # to the parameter's last bits
        torch.testing.assert_close(after[k], want[k], atol=1e-10, rtol=3e-7, msg=k)
    assert max(float((after[k] - params[k]).abs().max()) for k in params) > 0.9 * cfg["lr"]


# ------------------------------------------------------------------ the check

def _execute(seconds=0.3, traced=False):
    spec = bench.load_json(bench.ROOT / "BENCHMARK.json")
    run = bench.Run(spec, WORKLOAD, 1234567890123, torch.device("cpu"), cfg=_cfg(), mix=_mix())
    return bench.execute(run, seconds, traced)


def test_the_program_passes_the_check():
    out = _execute()
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"grad_gap", "update_gap", "pred_rms"}
    assert out["attempted"] > 0 and out["failed"] == 0
    r = out["readings"]
    assert r["unet.attn_rows"] == B * r["steps"]
    assert r["k1_launches"] == r["k2_launches"] == r["k3_launches"] == r["k4_launches"] == 0
    assert set(out["metrics"]) == {"train_windows_per_s", "setup_s"}


def test_the_bf16_control_fails_the_check(monkeypatch):
    real = train_unet.Runner.setup

    def setup(self):
        real(self)
        self.first = self.reference_steps("bf16")

    monkeypatch.setattr(train_unet.Runner, "setup", setup)
    out = _execute()
    assert not out["correct"], out["checks"]


def test_a_half_batch_fails_the_check(monkeypatch):
    real = DiffusionTask.loss_fn

    def loss_fn(self, batch, generator=None, train=True, **kw):
        half = batch["frame"].shape[0] // 2
        batch = {k: v[:half] for k, v in batch.items()}
        kw = {k: (v[:half] if torch.is_tensor(v) else v) for k, v in kw.items()}
        return real(self, batch, generator, train, **kw)

    monkeypatch.setattr(DiffusionTask, "loss_fn", loss_fn)
    out = _execute()
    assert not out["correct"], out["checks"]
    assert out["checks"]["pred_rms"]["value"] == float("inf")


# ------------------------------------------------------------------ counts

def _flop_counts(dim, frames, rows):
    from diffroll_tpu_torch.models import build

    with torch.device("meta"):
        net = build("SpecUnet", residual_channels=dim, frames=frames).net
        args = (torch.empty(rows, frames, 88), torch.zeros(rows, dtype=torch.long),
                torch.empty(rows, frames, 229))
    fc = FlopCounterMode(display=False)
    with fc:
        net(*args)
    return {str(k).split(".")[-1]: v for k, v in fc.get_flop_counts()["Global"].items()}


@pytest.mark.parametrize("dim,frames,rows", [(8, 32, 3), (6, 100, 2), (28, 640, 1)])
def test_counts_equal_the_flop_counter(dim, frames, rows):
    got = _flop_counts(dim, frames, rows)
    shape = counts.UShape(dim=dim, frames=frames)
    assert counts.forward_flops(shape, rows) == sum(got.values())
    if (dim, frames) == (28, 640):
        assert round(sum(got.values()) / 1e9, 2) == 110.70
        assert {k: round(v / 1e9, 2) for k, v in got.items()} == {
            "convolution": 102.39, "bmm": 7.84, "addmm": 0.46}


# ------------------------------------------------------------------ spans

def test_the_forward_emits_the_unet_spans_and_counts_attention_rows(tmp_path):
    cfg, _, model = _model()
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, cfg["frames"], 88, generator=g)
    cond = torch.randn(3, cfg["frames"], cfg["n_mels"], generator=g)
    before = unet.attn_rows
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.apply(x, torch.tensor([1, 2, 3]), cond)
    assert unet.attn_rows == before + 3
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    # 13 blocks, 5 linear attentions, the bottleneck, 2 down- and 2 up-levels;
    # 4 norms a block, 2 a linear attention, 1 before the bottleneck's; 2
    # depthwise convs a block, 1 in the up path's two lifting blocks
    assert {n: names.count(n) for n in set(names) if n.startswith("unet.")} == {
        "unet.block": 13, "unet.linear_attn": 5, "unet.attn": 1, "unet.resample": 4,
        "unet.norm": 63, "unet.dwconv": 24}


class _Run:
    def __init__(self, records, cfg=None, mix=None):
        self.records, self.cfg, self.mix = records, cfg or _cfg(), mix or _mix()


def _read(metric, run):
    path = bench.HERE / "metrics" / f"{metric}.py"
    return bench.load_module(path, f"bench_port.metrics.{metric}").read(run)


def _annotated(annotations, t1=10_000.0):
    """A stretch of [0, t1) us with device ops at [100, 300), [400, 900) and
    [950, 1000), and the card's annotations as (name, start, end)."""
    events = [{"ph": "X", "cat": "user_annotation", "name": bench_trace.MARK, "ts": 0.0,
               "dur": t1}]
    for a, b in ((100, 300), (400, 900), (950, 1000)):
        events.append({"ph": "X", "cat": "kernel", "name": "k", "ts": a, "dur": b - a})
    for name, a, b in annotations:
        events.append({"ph": "X", "cat": "gpu_user_annotation", "name": name, "ts": a,
                       "dur": b - a})
    return trace_annotated.Trace(events)


def test_device_time_inside_the_annotations():
    tr = _annotated([("unet.attn", 200, 500), ("unet.attn", 450, 600), ("unet.block", 0, 99),
                     ("unet.block", 980, 20_000)])
    assert tr.device_s_in("unet.attn") == pytest.approx((100 + 200) / 1e6)  # [200, 300), [400, 600)
    assert tr.device_s_in("unet.block") == pytest.approx(20 / 1e6)
    assert tr.device_s_in("unet.resample") == 0.0
    assert tr.busy_s == pytest.approx(750 / 1e6) and tr.window_s == pytest.approx(0.01)


@pytest.mark.parametrize("metric,span,bound", [
    ("unet.attn_roofline", "unet.attn", counts.attn_bound_s),
    ("unet.block_roofline", "unet.block", counts.blocks_bound_s),
    ("unet.norm_roofline", "unet.norm", unet_norms.norms_bound_s),
    ("unet.dwconv_roofline", "unet.dwconv", unet_dwconvs.dwconvs_bound_s)])
def test_roofline_readers(metric, span, bound):
    tr = _annotated([(span, 0, 2000)])
    run = _Run({"trace": tr, "traced_steps": 2})
    want = 100.0 * bound(counts.shape_of(run.cfg), B) / (750e-6 / 2)
    assert _read(metric, run) == pytest.approx(want)
    # a program without the spans, or a trace without the card's intervals
    assert _read(metric, _Run({"trace": _annotated([]), "traced_steps": 2})) is None
    plain = bench_trace.Trace([{"ph": "X", "cat": "user_annotation", "name": bench_trace.MARK,
                                "ts": 0.0, "dur": 10.0}])
    assert _read(metric, _Run({"trace": plain, "traced_steps": 2})) is None
    assert _read(metric, _Run({})) is None


def test_mfu_reader():
    tr = _annotated([])
    run = _Run({"trace": tr, "traced_steps": 2})
    want = 100.0 * 2 * B * 3 * counts.forward_flops(counts.shape_of(run.cfg)) / (
        0.01 * 989e12)
    assert _read("mfu.train_spec_unet", run) == pytest.approx(want)
    assert _read("mfu.train_spec_unet", _Run({})) is None
