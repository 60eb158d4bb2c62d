"""Latent Dirichlet Allocation on the device (the port of
``transmogrifai_tpu/ops/lda.py``, rewritten in torch).

Reference: core/.../stages/impl/feature/OpLDA.scala — wraps Spark mllib's
online variational LDA (Hoffman et al.) over a doc-term matrix, emitting a
topic-proportion vector per document. The variational EM is dense matrix
products on the (n, V) count matrix with FIXED iteration counts:

  E-step:  phi ∝ exp(E[log theta]) * exp(E[log beta])   (per doc-word)
  gamma  = alpha + (counts * phi-normalizer) @ exp(ElogBeta)^T
  M-step:  lambda = eta + exp(ElogTheta)^T-weighted expected counts

Vocabulary fitting and the count matrix are host-side (token counting,
like CountVectorizer); the count matrix reaches the device through the
port's pinned upload (``workflow.to_device``) and everything after it is
torch on that device.

The JAX package's two ``lax.scan`` loops are Python loops of the same
lengths here, with no host read inside them, so a fit on the card queues
its 30 x 20 E-steps without one synchronisation. The one difference:
the initial topic-word weights. JAX draws them with
``jax.random.gamma(PRNGKey(seed), 100.0, (k, V))``, which torch cannot
reproduce; the port draws Gamma(100) from a CPU ``torch.Generator``
seeded by ``seed``, and every entry point takes an initial ``lam0`` so a
caller can hand in any draws (the tests hand in JAX's).
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .._device import resolve_device
from ..dataset import Dataset
from ..features import types as ft
from ..features.manifest import ColumnManifest, ColumnMeta
from ..stages.base import UnaryEstimator
from .text import tokenize
from .vectorizers import VectorizerModel

#: an initial lambda: a (k, V) array, or a function of (k, V) giving one
Lam0 = Union[np.ndarray, torch.Tensor, Callable[[int, int], Any]]


def _dirichlet_expectation(a: torch.Tensor) -> torch.Tensor:
    """E[log X] for X ~ Dir(a), rows of a."""
    return torch.special.digamma(a) - torch.special.digamma(
        torch.sum(a, dim=-1, keepdim=True))


def _e_step(counts: torch.Tensor, elog_beta: torch.Tensor, alpha: float,
            n_iter: int):
    """Batch variational E-step; counts (n, V), elog_beta (K, V).
    Returns (gamma (n, K), sstats (K, V))."""
    n = counts.shape[0]
    K = elog_beta.shape[0]
    exp_elog_beta = torch.exp(elog_beta)                     # (K, V)
    gamma = torch.ones((n, K), dtype=counts.dtype, device=counts.device)
    for _ in range(n_iter):
        exp_elog_theta = torch.exp(_dirichlet_expectation(gamma))  # (n, K)
        # phi normalizer per doc-word: (n, V)
        phinorm = exp_elog_theta @ exp_elog_beta + 1e-30
        gamma = alpha + exp_elog_theta * (
            (counts / phinorm) @ exp_elog_beta.T)
    exp_elog_theta = torch.exp(_dirichlet_expectation(gamma))
    phinorm = exp_elog_theta @ exp_elog_beta + 1e-30
    sstats = exp_elog_beta * (exp_elog_theta.T @ (counts / phinorm))
    return gamma, sstats


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    from ..workflow import to_device
    return to_device(a, device)


def initial_lambda(k: int, V: int, seed: int = 0) -> torch.Tensor:
    """The port's own initial lambda on the CPU: Gamma(100) * 0.01 + 0.01
    drawn from a ``torch.Generator`` seeded by ``seed`` (the JAX
    package's formula over other draws)."""
    g = torch.Generator().manual_seed(int(seed))
    draws = torch._standard_gamma(
        torch.full((int(k), int(V)), 100.0, dtype=torch.float32),
        generator=g)
    return draws * 0.01 + 1e-2


def _lam0_tensor(lam0: Optional[Lam0], k: int, V: int, seed: int,
                 device: torch.device) -> torch.Tensor:
    if lam0 is None:
        lam0 = initial_lambda(k, V, seed)
    elif callable(lam0):
        lam0 = lam0(k, V)
    t = torch.as_tensor(lam0, dtype=torch.float32)
    if t.device != device:
        t = _upload(t.cpu().numpy(), device)
    if tuple(t.shape) != (k, V):
        raise ValueError(f"lam0 has shape {tuple(t.shape)}; the fit needs "
                         f"(k, V) = ({k}, {V})")
    return t


def fit_lda(counts: torch.Tensor, k: int, alpha: float = 0.1,
            eta: float = 0.01, em_iters: int = 30, e_iters: int = 20,
            seed: int = 0, lam0: Optional[Lam0] = None) -> torch.Tensor:
    """Batch variational EM on ``counts``' device; returns lambda (K, V)
    topic-word weights there. ``lam0``: the initial lambda (an array, or
    a function of (k, V)); None draws the port's own
    (:func:`initial_lambda`)."""
    V = counts.shape[1]
    lam = _lam0_tensor(lam0, int(k), int(V), seed, counts.device)
    for _ in range(int(em_iters)):
        elog_beta = _dirichlet_expectation(lam)
        _, sstats = _e_step(counts, elog_beta, alpha, e_iters)
        lam = eta + sstats
    return lam


def infer_topics(counts: torch.Tensor, lam: torch.Tensor,
                 alpha: float = 0.1, e_iters: int = 20) -> torch.Tensor:
    """Per-doc topic proportions (n, K), normalized."""
    gamma, _ = _e_step(counts, _dirichlet_expectation(lam), alpha, e_iters)
    return gamma / torch.sum(gamma, dim=1, keepdim=True)


def _doc_tokens(v: Any) -> List[str]:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [str(t) for t in v]
    return tokenize(str(v))


class LDAModel(VectorizerModel):
    """Fitted LDA: ``lam`` (K, V) lives on the stage's device
    (:meth:`to`); it persists as f32 numpy under ``lam``, as in the JAX
    package, so either package loads the other's."""
    in_type = ft.Text
    operation_name = "lda"

    def __init__(self, vocab: Sequence[str] = (), lam=None, k: int = 10,
                 alpha: float = 0.1, uid=None, **kw):
        super().__init__(uid=uid, vocab=list(vocab), k=int(k),
                         alpha=float(alpha), **kw)
        self.lam = self._as_tensor(lam)

    @staticmethod
    def _as_tensor(lam) -> Optional[torch.Tensor]:
        if lam is None:
            return None
        if isinstance(lam, torch.Tensor):
            return lam.to(torch.float32)
        return torch.from_numpy(np.array(lam, np.float32))

    @property
    def device(self) -> Optional[torch.device]:
        return None if self.lam is None else self.lam.device

    def to(self, device) -> "LDAModel":
        if self.lam is not None:
            self.lam = self.lam.to(torch.device(device))
        return self

    def extra_state_json(self):
        return {"lam": None if self.lam is None
                else self.lam.detach().cpu().numpy().astype(np.float32)}

    def load_extra_state(self, d):
        self.lam = self._as_tensor(d.get("lam"))

    def manifest(self) -> ColumnManifest:
        return ColumnManifest([
            ColumnMeta(self.parent_name, self.parent_type,
                       descriptor_value=f"topic_{i}")
            for i in range(self.params["k"])])

    def _count_matrix(self, col: np.ndarray) -> np.ndarray:
        vocab = {w: i for i, w in enumerate(self.params["vocab"])}
        out = np.zeros((len(col), len(vocab)), np.float32)
        for r, v in enumerate(col):
            for t in _doc_tokens(v):
                j = vocab.get(t)
                if j is not None:
                    out[r, j] += 1.0
        return out

    def _vectorize(self, col: np.ndarray) -> np.ndarray:
        counts = _upload(self._count_matrix(col), self.lam.device)
        return infer_topics(counts, self.lam,
                            self.params["alpha"]).cpu().numpy()


class OpLDA(UnaryEstimator):
    """Text/TextList -> (k,) topic-proportion OPVector.

    Vocabulary = top `vocab_size` tokens by document frequency; topics fit
    by variational EM (fixed iterations) on ``device`` (None: CUDA,
    raising without a card; ``Workflow.train(device=)`` sets it).
    ``lam0``: the initial lambda (see :func:`fit_lda`); not a param, so
    the stage's JSON is the JAX package's."""
    in_type = ft.Text
    out_type = ft.OPVector
    operation_name = "lda"
    model_cls = LDAModel

    def __init__(self, k: int = 10, vocab_size: int = 512,
                 alpha: float = 0.1, eta: float = 0.01, em_iters: int = 30,
                 seed: int = 0, uid=None, device=None,
                 lam0: Optional[Lam0] = None, **kw):
        super().__init__(uid=uid, k=int(k), vocab_size=int(vocab_size),
                         alpha=float(alpha), eta=float(eta),
                         em_iters=int(em_iters), seed=int(seed), **kw)
        self.device = device
        self.lam0 = lam0

    def fit_fn(self, ds: Dataset) -> Dict[str, Any]:
        dev = resolve_device(self.device)
        col = ds.column(self.input_names[0])
        df: Counter = Counter()
        for v in col:
            df.update(set(_doc_tokens(v)))
        vocab = [w for w, _ in sorted(df.items(),
                                      key=lambda t: (-t[1], t[0]))
                 [: self.params["vocab_size"]]]
        tmp = LDAModel(vocab=vocab, k=self.params["k"],
                       alpha=self.params["alpha"])
        tmp.inputs = self.inputs
        counts = _upload(tmp._count_matrix(col), dev)
        lam = fit_lda(counts, self.params["k"], self.params["alpha"],
                      self.params["eta"], self.params["em_iters"],
                      seed=self.params["seed"], lam0=self.lam0)
        return {"vocab": vocab, "lam": lam,
                "k": self.params["k"], "alpha": self.params["alpha"]}

    def _make_model(self, model_args):
        lam = model_args.pop("lam")
        model = super()._make_model(model_args)
        model.lam = lam
        return model
