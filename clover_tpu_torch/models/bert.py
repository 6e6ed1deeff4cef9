"""BERT text tower (port of ``clover_tpu/models/bert.py``).

Post-LN encoder layers with HF semantics: additive -10000 key mask, erf
GELU, LayerNorm eps 1e-12. In eval the embedding norm and the attention
norms are the forward-only LayerNorm kernel sites (K4) and the FFN half is
the post-LN MLP kernel (K3), each through its registered op
(``ops.library``). In training (``train()`` mode) the JAX package
keeps the norms in XLA, so they run plain here, with dropout on the
embeddings, the attention probabilities and the hidden outputs drawn from
the generator passed to ``forward``. The FFN half in training is plain too
unless ``BertConfig.fused_mlp_train`` picks the fused route for the layer
(the JAX ``CLOVER_BERT_MLP_TRAIN``): then it is ``FusedMlpPostlnDropoutFn``
(K3M, with the hidden dropout as a mask drawn from the generator).
Self-attention itself stays plain PyTorch, as it is plain XLA in the JAX
package. Parameter names follow the JAX tree (``embeddings``,
``encoder.layer_{i}.{attention.{query,key,value}, attention_output,
attention_norm, intermediate, output, output_norm}``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from clover_tpu_torch.models.layers import LayerNorm, Linear, dropout, dropout_mask, remat
from clover_tpu_torch.ops import library
from clover_tpu_torch.ops.mlp_block import FusedMlpPostlnDropoutFn, mlp_postln_plain

# additive fill for padded keys (transformers==4.6.1, the reference's pin)
ATTENTION_MASK_FILL = -10000.0
# fused_mlp_train='auto' takes the fused FFN only for layers of at least this
# many tokens (the fusion tower's batched pass; the JAX _FUSED_TRAIN_MIN_ROWS)
FUSED_TRAIN_MIN_ROWS = 2048


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The fields of ``clover_tpu.models.bert.BertConfig`` the port reads."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    # the FFN half on training passes: '0' plain (the JAX default), '1' the
    # fused K3M route in every layer, 'auto' only in layers of at least
    # FUSED_TRAIN_MIN_ROWS tokens (the JAX CLOVER_BERT_MLP_TRAIN)
    fused_mlp_train: str = "0"

    def __post_init__(self):
        if self.fused_mlp_train not in ("0", "1", "auto"):
            raise ValueError(f"fused_mlp_train must be '0', '1' or 'auto', "
                             f"got {self.fused_mlp_train!r}")

    def fused_train(self, rows: int) -> bool:
        """Does a training layer of ``rows`` tokens take the fused FFN route?"""
        return self.fused_mlp_train == "1" or (self.fused_mlp_train == "auto"
                                               and rows >= FUSED_TRAIN_MIN_ROWS)


def extend_attention_mask(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(B, S) 1/0 mask -> (B, 1, 1, S) additive mask (HF semantics)."""
    mask = mask.to(dtype)
    return ((1.0 - mask) * ATTENTION_MASK_FILL)[:, None, None, :]


class BertEmbeddings(nn.Module):
    """Token + absolute-position + token-type embeddings, then LN; output in
    ``dtype``. ``token_type_ids`` None gives every token type 0;
    ``position_offset`` starts the positions there (HF
    ``past_key_values_length``, the fusion tower's ``word_pos_start``)."""

    def __init__(self, cfg: BertConfig, kernels: bool = True):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, kernel=kernels)
        self.drop = cfg.hidden_dropout

    def forward(self, input_ids: torch.Tensor, dtype: torch.dtype,
                generator: Optional[torch.Generator] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                position_offset: int = 0) -> torch.Tensor:
        pos = torch.arange(position_offset, position_offset + input_ids.shape[-1],
                           device=input_ids.device)
        types = (self.token_type_embeddings.weight[0] if token_type_ids is None
                 else self.token_type_embeddings(token_type_ids))
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)[None] + types
        return dropout(self.norm(x.to(dtype)), self.drop, generator, self.training)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.query = Linear(cfg.hidden_size, cfg.hidden_size, init="normal")
        self.key = Linear(cfg.hidden_size, cfg.hidden_size, init="normal")
        self.value = Linear(cfg.hidden_size, cfg.hidden_size, init="normal")
        self.drop = cfg.attention_dropout

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, S, C = x.shape

        def heads(t):
            return t.view(B, S, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        logits = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(self.head_dim))
        if attn_bias is not None:
            logits = logits + attn_bias.to(logits.dtype)
        probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        probs = dropout(probs, self.drop, generator, self.training)
        return torch.matmul(probs, v).transpose(1, 2).reshape(B, S, C)


class BertLayer(nn.Module):
    """Post-LN layer: attention + dropout + residual + LN, then the FFN half
    LN(x + dropout(fc2(gelu(fc1(x))))), fused (K3) in eval. In training the
    route of the FFN half depends on ``cfg.fused_train(rows)`` alone, never
    on ``kernels``, so the kernel path and the plain path draw the same
    dropout from the same generator."""

    def __init__(self, cfg: BertConfig, kernels: bool = True):
        super().__init__()
        C = cfg.hidden_size
        self.cfg = cfg
        self.eps = cfg.layer_norm_eps
        self.kernels = kernels
        self.attention = BertSelfAttention(cfg)
        self.attention_output = Linear(C, C, init="normal")
        self.attention_norm = LayerNorm(C, cfg.layer_norm_eps, kernel=kernels)
        self.intermediate = Linear(C, cfg.intermediate_size, init="normal")
        self.output = Linear(cfg.intermediate_size, C, init="normal")
        self.output_norm = LayerNorm(C, cfg.layer_norm_eps)
        self.drop = cfg.hidden_dropout

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        attn = self.attention_output(self.attention(x, attn_bias, generator))
        attn = dropout(attn, self.drop, generator, self.training)
        x = self.attention_norm(x + attn)
        C = x.shape[-1]
        x2 = x.reshape(-1, C)
        args = (x2, self.output_norm.weight, self.output_norm.bias, self.intermediate.weight,
                self.intermediate.bias, self.output.weight, self.output.bias)
        if not self.training:
            op = library.k3_mlp_postln if self.kernels else mlp_postln_plain
            return op(*args, self.eps).view(x.shape)
        if not self.cfg.fused_train(x2.shape[0]):
            # the JAX train path's unfused FFN (bert.py:196-205)
            h = self.intermediate(x)
            h = self.output(F.gelu(h.float()).to(h.dtype))
            return self.output_norm(x + dropout(h, self.drop, generator, True))
        # the fused route: the hidden dropout as a {0, 1/keep} fp32 mask
        # (none at rate 0, the JAX fused_mlp_postln there)
        mask = None
        if self.drop > 0.0:
            mask = dropout_mask(x2.shape, self.drop, generator, x.device)
        out = FusedMlpPostlnDropoutFn.apply(*args, mask, self.eps, self.kernels)
        return out.view(x.shape)


class BertEncoder(nn.Module):
    """The stack of post-LN layers; with ``remat`` each layer runs through
    :func:`remat` where autograd records (the JAX ``nn.remat(BertLayer)``)."""

    def __init__(self, cfg: BertConfig, kernels: bool = True, remat: bool = False):
        super().__init__()
        self.num_layers = cfg.num_hidden_layers
        self.remat = remat
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg, kernels))

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        checkpointed = self.remat and torch.is_grad_enabled()
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            if checkpointed:
                x = remat(layer, x, attn_bias, generator=generator)
            else:
                x = layer(x, attn_bias, generator)
        return x


class BertTextEncoder(nn.Module):
    """Embeddings + encoder -> (B, S, hidden) last hidden state in ``dtype``."""

    def __init__(self, cfg: BertConfig = BertConfig(), dtype: torch.dtype = torch.float32,
                 kernels: bool = True, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.embeddings = BertEmbeddings(cfg, kernels)
        self.encoder = BertEncoder(cfg, kernels, remat)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        x = self.embeddings(input_ids, self.dtype, generator)
        return self.encoder(x, extend_attention_mask(attention_mask), generator)


class BertPredictionTransform(nn.Module):
    """dense -> erf GELU -> LayerNorm, the MLM head's transform (reference
    mlm_itm_head.py:10-22); the norm is plain, as it is XLA in the JAX
    package."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size, init="normal")
        self.norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dense(x)
        return self.norm(F.gelu(x.float()).to(x.dtype))
