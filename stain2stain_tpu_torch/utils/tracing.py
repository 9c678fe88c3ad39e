"""Spans at the port's layer boundaries, recorded while a profiler records.

A span is a named interval of host time with an id, its parent's id and its
root's id (one request or one train step shares a root id), a few integer
attributes set where the work happens (``tiles``, ``slots``, ``pixels``,
``step``) and the thread it ran on. Roots are explicit::

    with tracing.root("serve.request") as req:
        with tracing.span("serve.read"):
            ...
        req.set(pixels=h * w)

A root is traced whole or not at all, decided when it begins: it is traced
when a ``torch.profiler`` session is recording at that moment (the
benchmark's ``--trace 1`` run, ``trainer.profiler=advanced``). There is no
other switch. A child outside any root, or inside an untraced one, does
nothing; a root begun inside an open tree of the same context joins it
(``set`` then sets the outer root's attributes). With no profiler running a
root costs a context-variable read, one global read and a context-variable
set and reset, a child one context-variable read. No span draws from a
generator or synchronises the card; none may sit inside code that
``torch.export`` or ``torch.compile`` traces.

Times are ``time.time_ns()``, the clock of the profiler's own events (unix
ns). While the profiler records, each span also enters the profiler's trace
as a CPU event of its name (``_RecordFunctionFast``: a plain function event,
not a user annotation, so no device-side copy of it is made), where it
labels the card's idle gaps beside the host operations.

A traced tree enters a bounded buffer, which counts what it drops, whole
when its root ends. :func:`spans` returns the trees of the roots that began
during the latest profiling session; a session's start clears the buffer.
"""

from __future__ import annotations

import collections
import contextvars
import itertools
import threading
import time

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

__all__ = ["Span", "root", "span", "spans", "dropped", "CAPACITY"]

CAPACITY = 1 << 16  # finished spans kept; the oldest go first

# the open span of this context: a Span, False inside an untraced root, None outside any
_open: contextvars.ContextVar = contextvars.ContextVar("s2s_open_span", default=None)
_ids = itertools.count(1)
_lock = threading.Lock()
_finished: collections.deque = collections.deque(maxlen=CAPACITY)
_session = 0  # profiling sessions started since import
_dropped = 0  # spans of the latest session pushed out of the buffer


class Span:
    """One span. ``start_ns``/``end_ns`` in unix ns; ``parent`` is None for a root."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "root", "attrs", "thread",
                 "_top", "_tree", "_session", "_rf", "_token", "_keep")

    def __init__(self, name: str, parent: "Span | None", attrs: dict):
        self.name = name
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.root = self.id if parent is None else parent.root
        self._top = self if parent is None else parent._top
        self._tree = [] if parent is None else None  # a root's finished descendants
        self._session = _session if parent is None else parent._session
        self.attrs = attrs
        self.thread = threading.get_ident()
        self._keep = True

    def set(self, **attrs: int) -> None:
        self.attrs.update(attrs)

    def drop(self) -> None:
        """Keep nothing of this root's tree when it ends (its profiler events stay)."""
        self._keep = False

    def __enter__(self) -> "Span":
        self._token = _open.set(self)
        self._rf = _RecordFunctionFast(self.name) if _profiler._is_profiler_enabled else None
        if self._rf is not None:
            self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        _open.reset(self._token)
        if self._tree is None:
            self._top._tree.append(self)
        elif self._keep:
            _finish(self)
        return False


class _Nothing:
    """What a child outside a traced tree, or a joined root, hands out."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: int) -> None:
        pass

    def drop(self) -> None:
        pass


_NOTHING = _Nothing()


class _Untraced(_Nothing):
    """An untraced root: marks its context so that a root begun inside it stays untraced too."""

    __slots__ = ("_token",)

    def __enter__(self):
        self._token = _open.set(False)
        return self

    def __exit__(self, *exc) -> bool:
        _open.reset(self._token)
        return False


class _Joined(_Nothing):
    """A root begun inside an open traced tree: ``set`` reaches the tree's root."""

    __slots__ = ("_top",)

    def __init__(self, open_span: Span):
        self._top = open_span._top

    def set(self, **attrs: int) -> None:
        self._top.attrs.update(attrs)


def root(name: str, **attrs: int):
    """A root span named ``name``: traced if a profiler records now, else nothing."""
    current = _open.get()
    if current is not None:
        return _Joined(current) if current else _NOTHING
    if not _profiler._is_profiler_enabled:
        return _Untraced()
    return Span(name, None, attrs)


def span(name: str, **attrs: int):
    """A child of the open span, or nothing outside a traced root."""
    current = _open.get()
    if not current:
        return _NOTHING
    return Span(name, current, attrs)


def _finish(top: Span) -> None:
    """Keep a finished root and its tree, if its session is the latest."""
    global _dropped
    tree = top._tree + [top]
    top._tree = []
    with _lock:
        if top._session != _session:
            return
        _dropped += max(0, len(_finished) + len(tree) - CAPACITY)
        _finished.extend(tree)


def spans() -> list[Span]:
    """The spans of the finished roots that began during the latest profiling session."""
    with _lock:
        return list(_finished)


def dropped() -> int:
    """Spans of the latest session that the bounded buffer let go."""
    return _dropped


def _on_profiler_start(_start=_profiler._run_on_profiler_start) -> None:
    global _session, _dropped
    with _lock:  # before the profiler reads as on, so a root that sees it on has the new session
        _session += 1
        _dropped = 0
        _finished.clear()
    _start()


# torch calls this module-level hook by name at every profiler start
if not getattr(_profiler._run_on_profiler_start, "_s2s_tracing", False):
    _on_profiler_start._s2s_tracing = True
    _profiler._run_on_profiler_start = _on_profiler_start
