"""mx.contrib.text, the port of ``mxtpu/contrib/text.py``: vocabulary
and token-embedding containers feeding ``nn.Embedding``. Pretrained
GloVe/fastText tables are read from local files in their text format,
and ``CustomEmbedding`` covers user-supplied tables. The tables are
built on the host in numpy; ``idx_to_vec`` and the vectors handed out
are NDArrays on ``ctx`` (None: the innermost ``with ctx:`` scope, else
the card).
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence

import numpy as onp

from ..base import MXNetError
from .. import ndarray as nd

__all__ = ["Vocabulary", "CustomEmbedding", "count_tokens_from_str"]


def count_tokens_from_str(source_str: str, token_delim: str = " ",
                          seq_delim: str = "\n", to_lower: bool = False,
                          counter_to_update=None):
    """Token frequency counter (reference
    ``text.utils.count_tokens_from_str``)."""
    source = source_str.lower() if to_lower else source_str
    tokens = source.replace(seq_delim, token_delim).split(token_delim)
    tokens = [t for t in tokens if t]
    counter = counter_to_update if counter_to_update is not None \
        else collections.Counter()
    counter.update(tokens)
    return counter


class Vocabulary:
    """Indexed vocabulary (reference ``text.vocab.Vocabulary``):
    tokens sorted by frequency (ties broken lexically), index 0 is the
    unknown token, optional reserved tokens follow it."""

    def __init__(self, counter=None, most_freq_count: Optional[int] = None,
                 min_freq: int = 1, unknown_token: str = "<unk>",
                 reserved_tokens: Optional[Sequence[str]] = None):
        if min_freq < 1:
            raise MXNetError("min_freq must be >= 1")
        reserved_tokens = list(reserved_tokens or [])
        if unknown_token in reserved_tokens:
            raise MXNetError("unknown_token must not be reserved")
        if len(set(reserved_tokens)) != len(reserved_tokens):
            raise MXNetError("reserved_tokens contains duplicates")
        self._unknown_token = unknown_token
        self._idx_to_token: List[str] = [unknown_token] + reserved_tokens
        self._token_to_idx: Dict[str, int] = {
            t: i for i, t in enumerate(self._idx_to_token)}
        if counter is not None:
            pairs = sorted(counter.items(),
                           key=lambda kv: (-kv[1], kv[0]))
            if most_freq_count is not None:
                pairs = pairs[:most_freq_count]
            for tok, freq in pairs:
                if freq < min_freq:
                    continue
                if tok in self._token_to_idx:
                    continue
                self._token_to_idx[tok] = len(self._idx_to_token)
                self._idx_to_token.append(tok)

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def token_to_idx(self):
        return self._token_to_idx

    def to_indices(self, tokens):
        """Token(s) → index/indices; unknowns map to index 0."""
        if isinstance(tokens, str):
            return self._token_to_idx.get(tokens, 0)
        return [self._token_to_idx.get(t, 0) for t in tokens]

    def to_tokens(self, indices):
        if isinstance(indices, int):
            indices = [indices]
            single = True
        else:
            single = False
        out = []
        for i in indices:
            if not 0 <= i < len(self._idx_to_token):
                raise MXNetError(f"index {i} out of vocabulary range")
            out.append(self._idx_to_token[i])
        return out[0] if single else out


class CustomEmbedding:
    """Token embedding from a user table or a text file of
    ``token v1 v2 ...`` lines (reference ``text.embedding`` family —
    the file format GloVe/fastText ship)."""

    def __init__(self, file_path: Optional[str] = None,
                 vocabulary: Optional[Vocabulary] = None,
                 tokens: Optional[Sequence[str]] = None,
                 vectors=None, elem_delim: str = " ",
                 init_unknown_vec=None, ctx=None):
        table: Dict[str, onp.ndarray] = {}
        dim = None
        if file_path is not None:
            with open(file_path, encoding="utf-8") as f:
                for lineno, line in enumerate(f):
                    parts = line.rstrip("\n").split(elem_delim)
                    if len(parts) < 2:
                        continue
                    if lineno == 0 and len(parts) == 2:
                        try:             # fastText '<count> <dim>' header
                            int(parts[0]), int(parts[1])
                            continue
                        except ValueError:
                            pass
                    try:
                        vec = onp.asarray([float(x) for x in parts[1:]
                                           if x], onp.float32)
                    except ValueError:
                        continue         # malformed line (token w/ delim)
                    if vec.size == 0:
                        continue
                    if dim is None:
                        dim = vec.size
                    elif vec.size != dim:
                        continue
                    table[parts[0]] = vec
        if tokens is not None:
            vec_np = vectors.asnumpy() if hasattr(vectors, "asnumpy") \
                else onp.asarray(vectors, onp.float32)
            if len(tokens) != vec_np.shape[0]:
                raise MXNetError("tokens/vectors length mismatch")
            dim = vec_np.shape[1]
            for t, v in zip(tokens, vec_np):
                table[t] = onp.asarray(v, onp.float32)
        if dim is None:
            raise MXNetError("no embedding source given")
        self.vec_len = int(dim)
        self._table = table
        self._unk = (init_unknown_vec(dim) if init_unknown_vec
                     else onp.zeros(dim, onp.float32))
        self._vocab = vocabulary
        self._ctx = ctx
        if vocabulary is not None:
            rows = [self._table.get(t, self._unk)
                    for t in vocabulary.idx_to_token]
            # ONE stored NDArray (reference semantics: in-place writes
            # to idx_to_vec persist; a per-access copy would lose them)
            self._idx_to_vec = nd.array(onp.stack(rows), ctx=ctx)
        else:
            self._idx_to_vec = None

    @property
    def idx_to_vec(self):
        """(vocab, dim) NDArray aligned to the attached Vocabulary —
        drop into ``nn.Embedding(...).weight.set_data``."""
        if self._idx_to_vec is None:
            raise MXNetError("no Vocabulary attached")
        return self._idx_to_vec

    def get_vecs_by_tokens(self, tokens, lower_case_backup: bool = False):
        single = isinstance(tokens, str)
        toks = [tokens] if single else list(tokens)
        rows = []
        for t in toks:
            v = self._table.get(t)
            if v is None and lower_case_backup:
                v = self._table.get(t.lower())
            rows.append(v if v is not None else self._unk)
        out = nd.array(onp.stack(rows), ctx=self._ctx)
        return out[0] if single else out

    def update_token_vectors(self, tokens, new_vectors):
        """Overwrite vectors for tokens known to the table OR the
        attached vocabulary (the reference's main use: initializing
        OOV rows)."""
        toks = [tokens] if isinstance(tokens, str) else list(tokens)
        vec = new_vectors.asnumpy() if hasattr(new_vectors, "asnumpy") \
            else onp.asarray(new_vectors, onp.float32)
        vec = vec.reshape(len(toks), -1)
        if vec.shape[1] != self.vec_len:
            raise MXNetError(
                f"vector width {vec.shape[1]} != vec_len {self.vec_len}")
        for t in toks:     # validate ALL before mutating ANY state
            if t not in self._table and not (
                    self._vocab is not None
                    and t in self._vocab.token_to_idx):
                raise MXNetError(
                    f"token {t!r} in neither the embedding table nor "
                    "the attached vocabulary")
        for t, v in zip(toks, vec):
            self._table[t] = onp.asarray(v, onp.float32)
            if self._vocab is not None and t in self._vocab.token_to_idx:
                i = self._vocab.token_to_idx[t]
                self._idx_to_vec[i] = nd.array(
                    v, ctx=self._idx_to_vec.context)
