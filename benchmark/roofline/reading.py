"""What the per-layer readers share: the device's idle share, a model's
share of the bf16 peak, and a kernel's share of its roofline, from the
traced window and the counts a traffic driver kept."""

from __future__ import annotations

from benchmark.roofline import PEAK_OPS, k1_augment, k4_attention, kernel_roofline

# kernel names of the port's kernels, as the device trace lists them
K1 = ("fused_augment_kernel",)
K2 = ("rank_counts_kernel",)
K3 = ("topk_pass1", "topk_pass2")
K4 = ("attention_mma", "attention_f32")


def idle_pct(run):
    tr = run.tracer
    if tr is None or tr.window_s <= 0.0 or tr.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu_pct(run, flops: float):
    """``flops`` of the window over (window x 989 TFLOP/s)."""
    if run.window_s <= 0.0 or flops <= 0.0:
        return None
    return 100.0 * flops / (run.window_s * PEAK_OPS["bf16"])


def kernel_pct(run, names, launches: list):
    """Σ least time of ``launches`` over the device time of the traced
    kernels named ``names``; None unless the trace holds exactly as many
    launches as ``launches`` lists."""
    if run.tracer is None:
        return None
    n, seconds = run.tracer.device_seconds(names)
    if n == 0 or n != len(launches):
        return None
    return kernel_roofline(launches, seconds)


def k4_forward_launches(batches: list, per_forward: list) -> list:
    """K4's launches for forwards at the given batch sizes: ``per_forward``
    [(launches, tokens, heads, head dim)] a forward, as the model's
    reference module's ``attention(cfg)`` gives them."""
    out = []
    for b in batches:
        for count, n, heads, hd in per_forward:
            out += [k4_attention(b, n, heads, hd)] * count
    return out


def _flops(run, train: bool) -> float:
    from benchmark.harness.models import reference

    return reference(run.config).flops(run.config, train)


# the readers of a training window, shared by the cells of every model family


def mining_share(run):
    """Share of the window spent in proxy mining (``Trainer.timer``'s
    ``proxy_mining`` spans, which end after a host sync), in %."""
    s = run.spans.get("proxy_mining")
    if s is None or run.window_s <= 0.0:
        return None
    return 100.0 * s / run.window_s


def train_mfu(run):
    """Model FLOPs of the window over (window x bf16 peak), in %: three
    training forwards for each valid slot of the optimizer steps, one
    inference forward for each mined image."""
    return mfu_pct(run, 3 * _flops(run, True) * run.counts["valid_slots"]
                   + _flops(run, False) * run.counts["mined_images"])


def k1_train(run):
    """K1 over the step's (B, H, W, 3) uint8 → bf16, once a step."""
    b, h, w = run.shapes["k1"]
    return kernel_pct(run, K1, [k1_augment(b, h, w)] * run.counts["steps"])


def k4_train(run):
    """K4's forward launches in the steps (batch B) and in mining (the
    extraction batch)."""
    s = run.shapes
    if not s.get("attention"):
        return None
    batches = ([run.counts["batch"]] * run.counts["steps"]
               + [s["extract_batch"]] * run.counts["mining_batches"])
    return kernel_pct(run, K4, k4_forward_launches(batches, s["attention"]))


def k4_eval(run):
    """K4's forward launches in extraction, at the extraction batch."""
    s = run.shapes
    if not s.get("attention"):
        return None
    batches = [s["extract_batch"]] * run.counts["extract_batches"]
    return kernel_pct(run, K4, k4_forward_launches(batches, s["attention"]))


def eval_mfu(run):
    """Model FLOPs of the window (one inference forward for each real image
    extracted) over (window x bf16 peak), in %."""
    return mfu_pct(run, _flops(run, False) * run.counts["images"])
