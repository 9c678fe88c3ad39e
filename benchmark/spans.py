"""The program's own spans as the per-layer readers see them: the trees of
the roots that began while the run's profiler recorded
(``stain2stain_tpu_torch.utils.tracing.spans()``), read in the process that
ran them. A program that records no spans, an untraced run or too few
traced roots give None, the last two with a note saying why. The serve
driver counts the traced roots that have ended (:func:`finished_roots`) to
keep its trace on until the readers have enough."""

from __future__ import annotations


def trees(record, metric: str, root: str, least: int = 1):
    """The spans of the traced roots named ``root`` (the roots included),
    or None with a note where there are fewer than ``least`` of them."""
    if record.trace is None:
        return None
    try:
        from stain2stain_tpu_torch.utils import tracing
    except ImportError:
        record.note(f"{metric} left out: the program records no spans")
        return None
    found = tracing.spans()
    roots = {s.id for s in found if s.parent is None and s.name == root}
    if len(roots) < least:
        record.note(f"{metric} left out: {len(roots)} traced {root} roots, fewer than {least}")
        return None
    return [s for s in found if s.root in roots]


def finished_roots(root: str):
    """How many roots named ``root`` that began in the latest profiling
    session have ended so far, or None where the program records no spans."""
    try:
        from stain2stain_tpu_torch.utils import tracing
    except ImportError:
        return None
    return sum(1 for s in tracing.spans() if s.parent is None and s.name == root)


def named(spans: list, name: str) -> list:
    return [s for s in spans if s.name == name]


def total_ns(spans: list, *names: str) -> int:
    """The summed duration of the spans named ``names``."""
    return sum(s.end_ns - s.start_ns for s in spans if s.name in names)


def data_share(record, metric: str):
    """100 × Σ (``train.data_wait`` + ``train.prepare``) ÷ Σ ``train.step``
    over the traced steps, in %: the share of the step's host time in which
    the step fetched and prepared its batch. Read only where the traced
    steps are the ones the run profiled (``traced_steps``)."""
    spans = trees(record, metric, "train.step")
    if spans is None:
        return None
    steps = named(spans, "train.step")
    want = record.counts.get("traced_steps")
    if len(steps) != want:
        record.note(f"{metric} left out: {len(steps)} traced train.step roots, {want} steps profiled")
        return None
    return 100.0 * total_ns(spans, "train.data_wait", "train.prepare") / total_ns(steps, "train.step")
