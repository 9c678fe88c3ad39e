"""First-party hyperparameter sweeper (the port's copy of
``stain2stain_tpu/sweep.py``; hydra-optuna-sweeper's config surface).

``hparams_search/mnist_optuna.yaml`` attaches an Optuna-style TPE study
(``configs/hparams_search/mnist_optuna.yaml``); this module runs it with no
package beyond numpy:

- param spec grammar: ``interval(lo, hi)`` (uniform float),
  ``int(interval(lo, hi))``, ``choice(a, b, c)``, ``range(lo, hi[, step])``
- :class:`TPESampler` — Tree-structured-Parzen-Estimator-style sampling:
  after ``n_startup_trials`` random draws, observations split into good/bad
  by the γ=0.25 quantile; numeric params sample candidates from a Gaussian
  KDE over the good set and pick the best l(x)/g(x) ratio; categorical
  params sample from smoothed good-set frequencies. Its draws come from
  numpy's ``default_rng(seed)``, so for the same seed and objective values
  it proposes what the JAX package's sampler proposes, bit for bit.
- :class:`Sweeper` — runs ``n_trials`` (``n_jobs`` at a time, constant-liar
  batches), each trial re-running the task function on a config copy with
  the sampled overrides applied, journals every trial to a JSONL file when
  ``storage`` is set (a relaunch resumes), and reports the best value and
  params.
"""

from __future__ import annotations

import copy
import math
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from .config import Config, instantiate
from .utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)

_FUNC_RE = re.compile(r"^(\w+)\((.*)\)$")


@dataclass
class ParamSpace:
    kind: str  # 'float' | 'int' | 'choice'
    lo: float = 0.0
    hi: float = 1.0
    choices: tuple = ()


def parse_param(spec: Any) -> ParamSpace:
    """Parse the optuna-sweeper param grammar."""
    if isinstance(spec, (list, tuple)):
        return ParamSpace("choice", choices=tuple(spec))
    s = str(spec).strip()
    m = _FUNC_RE.match(s)
    if not m:
        raise ValueError(f"Cannot parse param spec: {spec!r}")
    fn, args = m.group(1), m.group(2)
    if fn == "int":
        inner = parse_param(args)
        return ParamSpace("int", lo=inner.lo, hi=inner.hi)
    parts = [a.strip() for a in args.split(",") if a.strip()]
    if fn == "interval":
        return ParamSpace("float", lo=float(parts[0]), hi=float(parts[1]))
    if fn == "range":
        lo, hi = int(float(parts[0])), int(float(parts[1]))
        step = int(float(parts[2])) if len(parts) > 2 else 1
        return ParamSpace("choice", choices=tuple(range(lo, hi, step)))
    if fn == "choice":
        import yaml

        return ParamSpace("choice", choices=tuple(yaml.safe_load(p) for p in parts))
    raise ValueError(f"Unknown param function {fn!r} in {spec!r}")


@dataclass
class TPESampler:
    seed: int = 0
    n_startup_trials: int = 10
    gamma: float = 0.25
    n_candidates: int = 24
    _rng: np.random.Generator = field(init=False, repr=False)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def _random(self, space: ParamSpace) -> Any:
        if space.kind == "choice":
            return space.choices[int(self._rng.integers(len(space.choices)))]
        val = self._rng.uniform(space.lo, space.hi)
        return int(round(val)) if space.kind == "int" else float(val)

    def suggest(
        self,
        spaces: dict[str, ParamSpace],
        history: list[tuple[dict, float]],
        direction: str,
    ) -> dict:
        """Sample one parameter assignment given (params, value) history."""
        if len(history) < self.n_startup_trials:
            return {k: self._random(sp) for k, sp in spaces.items()}
        values = np.array([v for _, v in history], dtype=float)
        order = np.argsort(values)
        if direction == "maximize":
            order = order[::-1]
        n_good = max(1, int(math.ceil(self.gamma * len(history))))
        good = [history[i][0] for i in order[:n_good]]
        bad = [history[i][0] for i in order[n_good:]] or good

        out: dict = {}
        for key, space in spaces.items():
            if space.kind == "choice":
                counts = {c: 1.0 for c in space.choices}  # +1 smoothing
                for g in good:
                    counts[g[key]] = counts.get(g[key], 1.0) + 1.0
                names = list(counts)
                p = np.array([counts[c] for c in names], dtype=float)
                out[key] = names[int(self._rng.choice(len(names), p=p / p.sum()))]
            else:
                g_obs = np.array([g[key] for g in good], dtype=float)
                b_obs = np.array([b[key] for b in bad], dtype=float)
                width = max((space.hi - space.lo) / 10.0, 1e-12)
                cands = np.clip(
                    g_obs[self._rng.integers(len(g_obs), size=self.n_candidates)]
                    + self._rng.normal(0, width, self.n_candidates),
                    space.lo,
                    space.hi,
                )

                def kde(obs, xs):
                    return np.mean(
                        np.exp(-0.5 * ((xs[:, None] - obs[None, :]) / width) ** 2), axis=1
                    ) + 1e-12

                score = kde(g_obs, cands) / kde(b_obs, cands)
                best = float(cands[int(np.argmax(score))])
                out[key] = int(round(best)) if space.kind == "int" else best
        return out


@dataclass
class Sweeper:
    direction: str = "minimize"
    n_trials: int = 20
    sampler: Optional[TPESampler] = None
    params: Optional[dict] = None
    study_name: Optional[str] = None
    # Study persistence (optuna RDB-storage equivalent): a JSONL journal, one
    # record per attempted trial. An interrupted sweep relaunched with the
    # same storage resumes after the recorded trials (history seeds the
    # sampler; completed attempts count toward n_trials). RDB URL prefixes
    # like sqlite:/// are accepted and mapped to a sibling .jsonl file.
    storage: Optional[str] = None
    # Concurrent trials (optuna n_jobs equivalent): trials run in a thread
    # pool, n_jobs at a time, each batch sampled from the shared history.
    # On a single accelerator the speedup is bounded by host/compile overlap.
    n_jobs: int = 1

    def _journal_path(self):
        if not self.storage:
            return None
        from pathlib import Path

        s = str(self.storage)
        if "://" in s:
            # an RDB URL: sqlite:///study.db (relative) or sqlite:////abs/study.db
            # (absolute) journals to the database path + ".jsonl"; the JAX
            # package strips every leading slash, so an absolute path there
            # becomes relative to the working directory
            s = s.split("://", 1)[1]
            s = s[1:] if s.startswith("/") else s
            s += ".jsonl"
        p = Path(s)
        p.parent.mkdir(parents=True, exist_ok=True)
        return p

    def _load_journal(self) -> list[dict]:
        import json

        path = self._journal_path()
        if path is None or not path.exists():
            return []
        records = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
        if records:
            log.info(f"Resuming study from {path}: {len(records)} recorded trials")
        return records

    def _append_journal(self, record: dict) -> None:
        import json

        path = self._journal_path()
        if path is None:
            return
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def optimize(self, objective: Callable[[dict], float]) -> tuple[float, dict]:
        sampler = self.sampler or TPESampler()
        spaces = {k: parse_param(v) for k, v in (self.params or {}).items()}
        records = self._load_journal()
        history: list[tuple[dict, float]] = [
            (r["params"], r["value"]) for r in records if r.get("value") is not None
        ]
        best_val, best_params = None, {}
        for params, value in history:
            if (
                best_val is None
                or (self.direction == "maximize" and value > best_val)
                or (self.direction == "minimize" and value < best_val)
            ):
                best_val, best_params = value, params

        import threading

        journal_lock = threading.Lock()

        def run_one(trial: int, assignment: dict):
            """Run one trial and journal it the moment it finishes — an
            interrupt mid-batch then loses at most the in-flight trials, not
            every finished trial of the batch (resume replays the journal)."""
            log.info(f"Trial {trial}/{self.n_trials}: {assignment}")
            try:
                value = float(objective(assignment))
            except Exception as ex:  # a failing trial must not kill the study
                log.warning(f"Trial {trial} failed: {ex}")
                value = None
            with journal_lock:
                self._append_journal({"trial": trial, "params": assignment, "value": value})
            return value

        attempts = len(records)
        n_jobs = max(1, int(self.n_jobs))
        while attempts < self.n_trials:
            batch = min(n_jobs, self.n_trials - attempts)
            # Constant-liar (CL-mean) batch sampling: each in-flight assignment
            # is appended to the sampler's view of history with the historical
            # mean as a placeholder value, so concurrent proposals spread out
            # instead of re-suggesting the same optimum-so-far region.
            # Non-finite trial values (a diverged objective returning nan)
            # would poison the mean and every subsequent suggestion's sort.
            finite = [v for _, v in history if np.isfinite(v)]
            lie = float(np.mean(finite)) if finite else 0.0
            assignments: list[dict] = []
            for _ in range(batch):
                pending = [(a, lie) for a in assignments]
                assignments.append(
                    sampler.suggest(spaces, history + pending, self.direction)
                )
            if batch == 1:
                values = [run_one(attempts, assignments[0])]
            else:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=batch) as pool:
                    values = list(
                        pool.map(run_one, range(attempts, attempts + batch), assignments)
                    )
            for assignment, value in zip(assignments, values):
                attempts += 1
                if value is None:
                    continue
                history.append((assignment, value))
                better = (
                    best_val is None
                    or (self.direction == "maximize" and value > best_val)
                    or (self.direction == "minimize" and value < best_val)
                )
                if better:
                    best_val, best_params = value, assignment
                log.info(f"Trial {attempts - 1} value={value:.5f} (best={best_val:.5f})")
        return best_val if best_val is not None else float("nan"), best_params


def run_study(cfg: Config, task_fn: Callable[[Config], dict]) -> Optional[float]:
    """Run the sweep attached via ``hparams_search``: each trial deep-copies
    the composed config, applies the sampled overrides, runs the task and
    reads ``optimized_metric`` from its metric dict."""
    sweeper: Sweeper = instantiate(cfg["sweeper"])
    metric_name = cfg.get("optimized_metric")
    if not metric_name:
        raise ValueError("hparams_search config must set optimized_metric")

    def objective(assignment: dict) -> float:
        trial_cfg = copy.deepcopy(cfg)
        for key, value in assignment.items():
            trial_cfg[key] = value
        metric_dict = task_fn(trial_cfg)
        if metric_name not in metric_dict:
            raise ValueError(f"optimized_metric '{metric_name}' not in {sorted(metric_dict)}")
        return float(metric_dict[metric_name])

    best_val, best_params = sweeper.optimize(objective)
    log.info(f"Study done: best {metric_name}={best_val:.5f} with {best_params}")
    return best_val


__all__ = ["Sweeper", "TPESampler", "ParamSpace", "parse_param", "run_study"]
