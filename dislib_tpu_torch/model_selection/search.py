"""Hyperparameter search.

Counterpart of ``dislib_tpu/model_selection/search.py``: GridSearchCV and
RandomizedSearchCV that dispatch every candidate's fit of a fold through
the estimator's ``_fit_async`` (no host reads) before any score is read,
with folds pipelined two-deep — fold f's scores are read only after fold
f+1's fits and scores are dispatched — so the card runs the trials' kernels
back to back while memory stays bounded at two folds.  Scores stay
tensors until then, and each read is counted in
``utils/profiling.HOST_READS["search"]``.  On a card one stream runs the
work in order, as a TPU core does, so the pipeline is always on; the
reference's switch to a throttled loop for its CPU backend
(``_pipeline_folds``, ``_block_tree``) has no counterpart, as torch runs
eagerly on the CPU and nothing is in flight there.  A fit that reads its
stop condition (``tol > 0``, ``runtime/loop``) still reads inside
``_fit_async``.  Estimators without an async path fall back
to a synchronous fit inside the dispatch loop.  Scoring accepts the
estimator's ``score``, a callable, or a scorer string ('accuracy', 'r2',
'neg_mean_squared_error').
"""

from __future__ import annotations

from itertools import product

import numpy as np
import torch

from dislib_tpu_torch.base import BaseEstimator, clone
from dislib_tpu_torch.model_selection.split import KFold
from dislib_tpu_torch.utils.profiling import host_read

def _read(v) -> float:
    """A trial's score on the host: a tensor through ``host_read``
    (counted under ``"search"``), anything else by ``float``."""
    return host_read(v, "search") if isinstance(v, torch.Tensor) \
        else float(v)


def _score(est, xv, yv):
    if hasattr(est, "score"):
        return est.score(xv, yv) if yv is not None else est.score(xv)
    raise TypeError(f"{type(est).__name__} has no score(); pass scoring=")


def _pred_np(est, xv):
    return np.asarray(est.predict(xv).collect()).ravel()


def _truth_np(yv):
    return np.asarray(yv.collect()).ravel()


def _accuracy(est, xv, yv):
    return float(np.mean(_pred_np(est, xv) == _truth_np(yv)))


def _r2(est, xv, yv):
    y = _truth_np(yv)
    resid = ((y - _pred_np(est, xv)) ** 2).sum()
    total = ((y - y.mean()) ** 2).sum()
    return float(1.0 - resid / max(total, 1e-12))


def _neg_mse(est, xv, yv):
    y = _truth_np(yv)
    return float(-np.mean((y - _pred_np(est, xv)) ** 2))


_SCORERS = {"accuracy": _accuracy, "r2": _r2,
            "neg_mean_squared_error": _neg_mse}


def _resolve_scorer(scoring):
    if scoring is None:
        return None
    if callable(scoring):
        return scoring
    if isinstance(scoring, str):
        if scoring not in _SCORERS:
            raise ValueError(f"unknown scorer {scoring!r}; known: "
                             f"{sorted(_SCORERS)} (or pass a callable)")
        return _SCORERS[scoring]
    raise TypeError(f"scoring must be None, str or callable, got "
                    f"{type(scoring).__name__}")


class GridSearchCV(BaseEstimator):
    """Exhaustive search over a parameter grid with K-fold CV.

    Attributes: cv_results_, best_params_, best_score_, best_index_,
    best_estimator_ (when refit=True).
    """

    def __init__(self, estimator, param_grid, cv=5, scoring=None, refit=True):
        self.estimator = estimator
        self.param_grid = param_grid
        self.cv = cv
        self.scoring = scoring
        self.refit = refit

    def _candidates(self):
        grid = self.param_grid
        if isinstance(grid, dict):
            grid = [grid]
        out = []
        for g in grid:
            keys = sorted(g)
            for combo in product(*(g[k] for k in keys)):
                out.append(dict(zip(keys, combo)))
        return out

    def fit(self, x, y=None):
        candidates = self._candidates()
        cv = self.cv if isinstance(self.cv, KFold) else KFold(n_splits=self.cv)
        n_folds = cv.get_n_splits()
        scorer = _resolve_scorer(self.scoring)

        # fold-pipelined loop: at most TWO folds' train/validation copies
        # are device-resident at a time, bounding memory regardless of cv
        # or candidate count, while fold f's host reads happen only AFTER
        # fold f+1's fits and scores are dispatched — the reference's
        # submit-all-before-wait contract holds across folds as well as
        # across candidates (SURVEY §4.5 "no artificial serialization").
        all_scores = np.zeros((len(candidates), n_folds))

        def _dispatch_fold(fold):
            xt, yt, xv, yv = fold
            pend = []
            for ci, params in enumerate(candidates):
                est = clone(self.estimator).set_params(**params)
                state = est._fit_async(xt, yt) if yt is not None \
                    else est._fit_async(xt)
                pend.append((ci, est, state))
            vals = []
            for ci, est, state in pend:
                if scorer is None:
                    vals.append((ci, est._score_async(state, xv, yv)))
                else:
                    est._fit_finalize(state)
                    vals.append((ci, scorer(est, xv, yv)))
            return vals

        prev = None                       # (fold_index, pending device scores)
        for fi, fold in enumerate(cv.split(x, y)):
            vals = _dispatch_fold(fold)
            if prev is not None:
                pfi, pvals = prev
                for ci, v in pvals:       # host sync for fold f-1 only now
                    all_scores[ci, pfi] = _read(v)
            prev = (fi, vals)
        if prev is not None:
            pfi, pvals = prev
            for ci, v in pvals:
                all_scores[ci, pfi] = _read(v)

        mean = all_scores.mean(axis=1)
        std = all_scores.std(axis=1)
        rank = np.argsort(-mean).argsort() + 1
        self.cv_results_ = {
            "params": candidates,
            "mean_test_score": mean,
            "std_test_score": std,
            "rank_test_score": rank.astype(int),
            **{f"split{j}_test_score": all_scores[:, j] for j in range(n_folds)},
        }
        self.best_index_ = int(np.argmax(mean))
        self.best_params_ = candidates[self.best_index_]
        self.best_score_ = float(mean[self.best_index_])
        if self.refit:
            self.best_estimator_ = clone(self.estimator).set_params(**self.best_params_)
            self.best_estimator_.fit(x, y) if y is not None else self.best_estimator_.fit(x)
        return self

    def _carry_in(self, arrays: dict, device):
        """The refit ``best_estimator_`` comes as an estimator of this
        package (``load_model`` restores it onto ``device`` first); the
        results are host values, kept as given."""
        best = arrays.get("best_estimator_")
        if best is not None and not isinstance(best, BaseEstimator):
            raise TypeError(f"best_estimator_ must be an estimator of this "
                            f"package, got {type(best).__name__}")
        if best is not None:
            self.best_estimator_ = best

    def predict(self, x):
        self._check_refit()
        return self.best_estimator_.predict(x)

    def score(self, x, y=None):
        self._check_refit()
        return _score(self.best_estimator_, x, y)

    def _check_refit(self):
        if not hasattr(self, "best_estimator_"):
            raise RuntimeError("search not fitted with refit=True")


class RandomizedSearchCV(GridSearchCV):
    """Randomized search: samples ``n_iter`` candidates from distributions
    (lists are sampled uniformly; scipy frozen distributions via .rvs)."""

    def __init__(self, estimator, param_distributions, n_iter=10, cv=5,
                 scoring=None, refit=True, random_state=None):
        super().__init__(estimator, param_grid=None, cv=cv, scoring=scoring,
                         refit=refit)
        self.param_distributions = param_distributions
        self.n_iter = n_iter
        self.random_state = random_state

    def _candidates(self):
        rng = np.random.RandomState(self.random_state)
        dists = self.param_distributions
        if isinstance(dists, dict):
            dists = [dists]
        out = []
        for _ in range(self.n_iter):
            d = dists[rng.randint(len(dists))]
            params = {}
            for k, v in d.items():
                if hasattr(v, "rvs"):
                    params[k] = v.rvs(random_state=rng)
                else:
                    params[k] = v[rng.randint(len(v))]
            out.append(params)
        return out
