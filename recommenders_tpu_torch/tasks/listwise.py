"""Listwise ranking losses.

Port of `recommenders_tpu/tasks/listwise.py` (the counterparts of
tensorflow-ranking's losses), shaped for `tasks.Ranking(loss_fn=...)`:

    task = tasks.Ranking(loss_fn=listwise.list_mle)
    out = task(labels_bl, scores_bl)

Every loss takes `[B, L]` labels and scores, optional `[B]` (or `[B, L]`)
sample weights and a validity `mask` (True = a real entry) for ragged
lists, and reduces to a scalar mean over lists.

Sorts are stable (`torch.argsort(stable=True)`, as `jnp.argsort(...,
stable=True)`), with `-inf` keys for masked entries so they sort last.
ListMLE's suffix log-sum-exp is `torch.logcumsumexp` over the reversed
list; the JAX package folds `logaddexp` with `associative_scan`, in
another order, so the two agree to a tolerance, not bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

_NEG = -1e12


def _prep(labels, scores, mask):
    labels = torch.as_tensor(labels).to(torch.float32)
    scores = torch.as_tensor(scores).to(torch.float32)
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.bool,
                          device=labels.device)
    return labels, scores, mask.to(torch.bool)


def _weighted_mean(per_example: Tensor,
                   sample_weight: Optional[Tensor]) -> Tensor:
    if sample_weight is not None:
        w = torch.reshape(sample_weight.to(torch.float32), per_example.shape)
        return torch.sum(per_example * w) / torch.clamp(torch.sum(w),
                                                         min=1e-12)
    return torch.mean(per_example)


def _positions(length: int, device) -> Tensor:
    return torch.arange(1, length + 1, dtype=torch.float32, device=device)


def _max_dcg(gains: Tensor) -> Tensor:
    """DCG of the gains in descending order: the ideal DCG per list."""
    ideal = torch.sort(gains, dim=1, descending=True).values
    positions = _positions(gains.shape[1], gains.device)
    return torch.sum(ideal / torch.log2(1.0 + positions)[None], dim=1)


def softmax_listwise(
    labels: Tensor,
    scores: Tensor,
    sample_weight: Optional[Tensor] = None,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """ListNet-style softmax cross-entropy: CE(normalize(labels),
    softmax(scores)) per list (tensorflow-ranking's SoftmaxLoss)."""
    labels, scores, mask = _prep(labels, scores, mask)
    scores = torch.where(mask, scores, _NEG)
    labels = torch.where(mask, labels, 0.0)
    label_dist = labels / torch.clamp(
        torch.sum(labels, dim=1, keepdim=True), min=1e-12)
    log_probs = torch.log_softmax(scores, dim=1)
    per_example = -torch.sum(
        label_dist * torch.where(mask, log_probs, 0.0), dim=1)
    return _weighted_mean(per_example, sample_weight)


def pairwise_logistic(
    labels: Tensor,
    scores: Tensor,
    sample_weight: Optional[Tensor] = None,
    mask: Optional[Tensor] = None,
    pair_weights: Optional[Tensor] = None,
) -> Tensor:
    """Pairwise logistic loss `log(1 + exp(-(s_i - s_j)))` over the pairs
    with `label_i > label_j` (tensorflow-ranking's PairwiseLogisticLoss);
    `pair_weights` optionally weights each `[B, L, L]` pair."""
    labels, scores, mask = _prep(labels, scores, mask)
    s_diff = scores[:, :, None] - scores[:, None, :]
    l_diff = labels[:, :, None] - labels[:, None, :]
    valid_pair = ((l_diff > 0) & mask[:, :, None]
                  & mask[:, None, :]).to(torch.float32)
    if pair_weights is not None:
        valid_pair = valid_pair * pair_weights
    losses = torch.clamp(-s_diff, min=0.0) + torch.log1p(
        torch.exp(-torch.abs(s_diff)))
    per_example = torch.sum(losses * valid_pair, dim=(1, 2)) / torch.clamp(
        torch.sum(valid_pair, dim=(1, 2)), min=1e-12)
    return _weighted_mean(per_example, sample_weight)


def ndcg_lambda_weights(
    labels: Tensor,
    scores: Tensor,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """LambdaRank pair weights `|ΔNDCG|` of swapping each pair, as a
    `[B, L, L]` tensor without gradient (ranks are constants):
    `|gain_i − gain_j| · |1/log2(1+r_i) − 1/log2(1+r_j)| / maxDCG`, with
    ranks `r` from the current scores (tensorflow-ranking's
    `NDCGLambdaWeight`)."""
    labels, scores, mask = _prep(labels, scores, mask)
    scores = scores.detach()
    batch, length = labels.shape
    sort_key = torch.where(mask, scores, -torch.inf)
    order = torch.argsort(-sort_key, dim=1, stable=True)
    # ranks[i] = 1-based position of item i in the descending order.
    ranks = torch.zeros_like(order).scatter_(
        1, order, torch.arange(1, length + 1, device=order.device)
        .expand(batch, length))
    gains = torch.where(mask, torch.pow(2.0, labels) - 1.0, 0.0)
    discounts = 1.0 / torch.log2(1.0 + ranks.to(torch.float32))
    max_dcg = _max_dcg(gains)
    inv_max = torch.where(max_dcg > 0,
                          1.0 / torch.clamp(max_dcg, min=1e-12), 0.0)
    gain_diff = torch.abs(gains[:, :, None] - gains[:, None, :])
    disc_diff = torch.abs(discounts[:, :, None] - discounts[:, None, :])
    return gain_diff * disc_diff * inv_max[:, None, None]


def dcg_lambda_weights(
    labels: Tensor,
    scores: Tensor,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Unnormalized `|ΔDCG|` pair weights (tensorflow-ranking's
    `DCGLambdaWeight`): the NDCG weights times each list's ideal DCG."""
    labels, scores, mask = _prep(labels, scores, mask)
    ndcg = ndcg_lambda_weights(labels, scores, mask)
    gains = torch.where(mask, torch.pow(2.0, labels) - 1.0, 0.0)
    return ndcg * _max_dcg(gains)[:, None, None]


def lambdarank(
    labels: Tensor,
    scores: Tensor,
    sample_weight: Optional[Tensor] = None,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Pairwise logistic loss with `|ΔNDCG|` lambda weights (LambdaRank)."""
    return pairwise_logistic(
        labels, scores, sample_weight=sample_weight, mask=mask,
        pair_weights=ndcg_lambda_weights(labels, scores, mask))


def list_mle(
    labels: Tensor,
    scores: Tensor,
    sample_weight: Optional[Tensor] = None,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """ListMLE: the negative log-likelihood of the label-descending
    permutation under the Plackett-Luce model (tensorflow-ranking's
    ListMLELoss): `-Σ_i [s_π(i) − logsumexp(s_π(i), ..., s_π(L))]`."""
    labels, scores, mask = _prep(labels, scores, mask)
    sort_key = torch.where(mask, labels, -torch.inf)
    order = torch.argsort(-sort_key, dim=1, stable=True)
    s_sorted = torch.gather(scores, 1, order)
    m_sorted = torch.gather(mask, 1, order)
    s_masked = torch.where(m_sorted, s_sorted, _NEG)
    suffix_lse = torch.flip(
        torch.logcumsumexp(torch.flip(s_masked, (1,)), dim=1), (1,))
    per_pos = (suffix_lse - s_sorted) * m_sorted.to(torch.float32)
    per_example = torch.sum(per_pos, dim=1) / torch.clamp(
        torch.sum(m_sorted, dim=1), min=1e-12)
    return _weighted_mean(per_example, sample_weight)


def approx_ndcg(
    labels: Tensor,
    scores: Tensor,
    sample_weight: Optional[Tensor] = None,
    mask: Optional[Tensor] = None,
    temperature: float = 0.1,
) -> Tensor:
    """ApproxNDCG: `-NDCG` with ranks replaced by a sigmoid-smoothed
    approximation (Qin et al.; tensorflow-ranking's ApproxNDCGLoss)."""
    labels, scores, mask = _prep(labels, scores, mask)
    valid_f = mask.to(torch.float32)
    s_diff = (scores[:, None, :] - scores[:, :, None]) / temperature
    pair_valid = mask[:, :, None] & mask[:, None, :]
    # approx_rank_i = 1 + Σ_{j≠i} sigmoid((s_j - s_i)/T)
    sig = torch.where(pair_valid, torch.sigmoid(s_diff), 0.0)
    diag = torch.eye(labels.shape[1], dtype=torch.float32,
                     device=labels.device)[None]
    approx_rank = 1.0 + torch.sum(sig * (1.0 - diag), dim=2)
    gains = (torch.pow(2.0, labels) - 1.0) * valid_f
    dcg = torch.sum(gains / torch.log2(1.0 + approx_rank), dim=1)
    ndcg = dcg / torch.clamp(_max_dcg(gains), min=1e-12)
    return _weighted_mean(-ndcg, sample_weight)
