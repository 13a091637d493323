"""Terminal epoch summary (the port's copy of the reference's
``obs/summary.py``): one aligned table from the canonical metric
namespace — the per-epoch view ``launch/train.py`` prints (steps/s,
idle split, per-tier hit rates, GB read, fault/restart counts)."""

from __future__ import annotations

from repro_torch.obs import names


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:,.3f}" if abs(v) < 1000 else f"{v:,.0f}"
    return f"{v:,}"


def epoch_summary(metrics: dict, *, epoch: int | None = None) -> str:
    """Render a flat canonical-metrics dict (``names.flatten_stats`` +
    ``names.train_metrics``) as the terminal summary table."""
    rows: list[tuple[str, str]] = []

    def row(label, name, fmt=None):
        if name in metrics:
            v = metrics[name]
            rows.append((label, fmt(v) if fmt else _fmt(v)))

    pct = lambda v: f"{v:.1%}"
    row("steps/s", "train.steps_per_s")
    row("consumer idle", "train.idle_fraction", pct)
    row("idle / busy (s)", "train.idle_s",
        lambda v: f"{v:.2f} / {metrics.get('train.busy_s', 0.0):.2f}")
    row("store hit rate", "store.hit_rate", pct)
    row("store GB read", "store.bytes_fetched", lambda v: f"{v / 1e9:.3f}")
    row("store block fetches", "store.block_fetches")
    row("devcache hit rate", "devcache.hit_rate", pct)
    row("devcache MB uploaded", "devcache.bytes_uploaded",
        lambda v: f"{v / 1e6:.2f}")
    row("edgecache hit rate", "edgecache.hit_rate", pct)
    faults = sum(metrics.get(names.canonical("store", k), 0)
                 for k in names.FAULT_KEYS)
    rows.append(("store faults", _fmt(faults)))
    row("lane restarts", "pipeline.lane_stall_restarts")
    row("lane failures", "pipeline.lane_failures")
    row("oracle batches replayed", "oracle.batches_replayed")

    title = "epoch summary" if epoch is None else f"epoch {epoch} summary"
    w = max(len(l) for l, _ in rows)
    wv = max(len(v) for _, v in rows)
    bar = "-" * (w + wv + 7)
    lines = [f"[obs] {title}", bar]
    lines += [f"  {l:<{w}}   {v:>{wv}}" for l, v in rows]
    lines.append(bar)
    return "\n".join(lines)
