"""Loss library: the training objectives of TRIS, batched.

Port of ``tris_tpu/losses.py`` (the reference's train_stage1.py:263-364,
train_stage2.py:301-319). Stage 1 uses ``max_loss``, ``clip_similarity``,
``cbs_loss`` and ``multilabel_soft_margin_loss``; the rest serve stage 2.
The CBS negative-expression loss is one einsum over the [B, S] negatives
where the reference loops over the batch in Python.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


def max_loss(similarity: torch.Tensor) -> torch.Tensor:
    """``-mean(log(clamp(sim, 1e-4, 0.9999)))`` (train_stage1.py:280-284)."""
    return -torch.log(similarity.clamp(0.0001, 0.9999)).mean()


def clip_similarity(image_features: torch.Tensor, text_features: torch.Tensor) -> torch.Tensor:
    """Per-pair cosine similarity of matched rows: [N, C] x [N, C] -> [N]."""
    return (l2_normalize(image_features) * l2_normalize(text_features)).sum(dim=-1)


def cbs_loss(image_features: torch.Tensor, neg_text_features: torch.Tensor) -> torch.Tensor:
    """Contrastive batch-suppression loss on negative expressions:
    ``mean_b mean_s -log(1 - cos(img_b, neg_{b,s}))`` with image_features
    [B, C] and neg_text_features [B, S, C] (train_stage1.py:342-353)."""
    scores = torch.einsum("bc,bsc->bs", l2_normalize(image_features),
                          l2_normalize(neg_text_features))
    return (-torch.log(1.0 - scores.clamp(-0.9999, 0.9999))).mean()


def multilabel_soft_margin_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``F.multilabel_soft_margin_loss`` written as the JAX package writes it:
    the mean over the batch of ``-[y log sig(x) + (1-y) log sig(-x)]``'s
    class mean."""
    per_class = -(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))
    return per_class.mean(dim=-1).mean()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``F.binary_cross_entropy_with_logits``, reduction 'mean'
    (model/model_stage2.py:139-141), in the JAX package's form."""
    targets = targets.to(logits.dtype)
    per_elem = logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return per_elem.mean()


def sigmoid_mse_consistency(student_logits, teacher_logits) -> torch.Tensor:
    """EMA consistency: MSE between sigmoids (train_stage2.py:258-269)."""
    return ((torch.sigmoid(student_logits) - torch.sigmoid(teacher_logits)) ** 2).mean()


def sigmoid_kl_consistency(student_logits, teacher_logits) -> torch.Tensor:
    """KL between Bernoulli distributions given logits."""
    p = torch.sigmoid(teacher_logits)
    log_q = F.logsigmoid(student_logits)
    log_1mq = F.logsigmoid(-student_logits)
    log_p = F.logsigmoid(teacher_logits)
    log_1mp = F.logsigmoid(-teacher_logits)
    return (p * (log_p - log_q) + (1 - p) * (log_1mp - log_1mq)).mean()
