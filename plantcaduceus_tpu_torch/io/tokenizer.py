"""Character-level DNA tokenizer.

Vocabulary layout follows the CharacterTokenizer lineage the released
PlantCaduceus models use (reference generator:
pretrain/llmlib/tokenization/hg38_char_tokenizer.py:45-56 — specials
[CLS]=0 [SEP]=1 [BOS]=2 [MASK]=3 [PAD]=4 [RESERVED]=5 [UNK]=6, characters
from 7). The released vocab carries lowercase ``a c g t n`` (reference usage
indexes the vocab with lowercase — src/zero_shot_score.py:109,118); encoding
is case-insensitive, as the reference feeds upper-cased genome windows
(src/zero_shot_score.py:196-198) through a lowercasing normalizer.

No special tokens are ever added around sequences: a 512-char window encodes
to exactly 512 ids (reference encode_plus usage, src/zero_shot_score.py:51-56).

``DnaTokenizer.from_hf_dir`` loads the vocab from a HuggingFace checkpoint
directory (tokenizer.json / tokenizer_config.json) so imported checkpoints
keep their exact id layout.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

SPECIAL_TOKENS = ("[CLS]", "[SEP]", "[BOS]", "[MASK]", "[PAD]", "[RESERVED]", "[UNK]")
DEFAULT_CHARACTERS = ("a", "c", "g", "t", "n")

COMPLEMENT = {"a": "t", "t": "a", "c": "g", "g": "c",
              "A": "T", "T": "A", "C": "G", "G": "C"}


def _folds_case(vocab: Dict[str, int]) -> bool:
    """True when every alphabetic single-char token is lowercase — the
    released-tokenizer layout whose artifact case-folds its input."""
    single = [t for t in vocab if len(t) == 1 and t.isalpha()]
    return bool(single) and all(t.islower() for t in single)


class DnaTokenizer:
    """Char-per-base tokenizer with numpy batch encoding."""

    def __init__(
        self,
        characters: Sequence[str] = DEFAULT_CHARACTERS,
        model_max_length: Optional[int] = None,
        lowercase: bool = True,
        vocab: Optional[Dict[str, int]] = None,
    ):
        self.lowercase = lowercase
        self.model_max_length = model_max_length
        if vocab is None:
            vocab = {tok: i for i, tok in enumerate(SPECIAL_TOKENS)}
            for i, ch in enumerate(characters):
                vocab[ch] = len(SPECIAL_TOKENS) + i
        self.vocab: Dict[str, int] = dict(vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}

        self.mask_token_id = self.vocab["[MASK]"]
        self.pad_token_id = self.vocab["[PAD]"]
        self.unk_token_id = self.vocab["[UNK]"]

        # Fast char -> id table (256 entries). Exact-case vocab entries always
        # win; case-folded variants are only added (when ``lowercase``) for
        # case variants the vocab does not itself define, so a deliberately
        # mixed-case vocab is never corrupted by folding.
        table = np.full(256, self.unk_token_id, np.int32)
        exact = set()
        for tok, idx in self.vocab.items():
            if len(tok) == 1:
                table[ord(tok)] = idx
                exact.add(ord(tok))
        if lowercase:
            for tok, idx in self.vocab.items():
                if len(tok) == 1:
                    for var in (tok.upper(), tok.lower()):
                        if ord(var) not in exact:
                            table[ord(var)] = idx
        self._table = table

    # -- core API ----------------------------------------------------------

    def get_vocab(self) -> Dict[str, int]:
        return dict(self.vocab)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, sequence: str) -> np.ndarray:
        """Encode one sequence -> int32 ids, one id per character."""
        buf = np.frombuffer(sequence.encode("latin-1"), np.uint8)
        return self._table[buf]

    def encode_batch(self, sequences: Iterable[str]) -> np.ndarray:
        """Encode equal-length sequences -> [B, L] int32."""
        seqs = list(sequences)
        if not seqs:
            return np.zeros((0, 0), np.int32)
        L = len(seqs[0])
        if any(len(s) != L for s in seqs):
            raise ValueError("encode_batch requires equal-length sequences")
        joined = "".join(seqs).encode("latin-1")
        buf = np.frombuffer(joined, np.uint8).reshape(len(seqs), L)
        return self._table[buf]

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self.inv_vocab.get(int(i), "[UNK]") for i in ids)

    def complement_map_ids(self) -> List[int]:
        """Per-id complement ids — the model-config complement map. Built the
        same way the reference injects it (caduceus.py:100-105): char ids map
        through A<->T / C<->G (case folded), everything else maps to itself."""
        cmap = list(range(self.vocab_size))
        for tok, idx in self.vocab.items():
            comp = COMPLEMENT.get(tok)
            if comp is not None:
                target = comp.lower() if self.lowercase else comp
                if target in self.vocab:
                    cmap[idx] = self.vocab[target]
        return cmap

    # -- HF interop --------------------------------------------------------

    @classmethod
    def from_hf_dir(cls, path) -> "DnaTokenizer":
        """Load vocab from a HF tokenizer directory (tokenizer.json or
        CharacterTokenizer-style tokenizer_config.json)."""
        p = Path(path)
        tj = p / "tokenizer.json"
        tc = p / "tokenizer_config.json"
        if tj.exists():
            data = json.loads(tj.read_text())
            vocab = dict(data["model"]["vocab"])
            for added in data.get("added_tokens", []):
                vocab.setdefault(added["content"], added["id"])
            # Case-fold when the tokenizer declares a Lowercase normalizer, or
            # when the alphabetic vocab is all-lowercase (the released
            # PlantCaduceus layout: lowercase acgt vocab fed upper-cased
            # windows — src/zero_shot_score.py:109,196 — so folding is what
            # the released artifact does). An uppercase or mixed-case vocab is
            # case-sensitive, matching the reference CharacterTokenizer
            # (hg38_char_tokenizer.py: unknown case -> [UNK]).
            lowercase = ("Lowercase" in json.dumps(data.get("normalizer") or {})
                         or _folds_case(vocab))
            return cls(vocab=vocab, lowercase=lowercase)
        if tc.exists():
            data = json.loads(tc.read_text())
            if "vocab" in data:  # our own save() format — exact round-trip
                return cls(vocab=data["vocab"],
                           model_max_length=data.get("model_max_length"),
                           lowercase=data.get("lowercase", True))
            chars = [t.get("content", t) if isinstance(t, dict) else t
                     for t in data.get("char_ords", data.get("characters", []))]
            if chars and isinstance(chars[0], int):
                chars = [chr(c) for c in chars]
            if not chars:
                chars = list(DEFAULT_CHARACTERS)
            return cls(characters=chars,
                       model_max_length=data.get("model_max_length"),
                       lowercase=_folds_case({c: i for i, c in enumerate(chars)}))
        raise FileNotFoundError(f"no tokenizer files found under {p}")

    def save(self, path) -> None:
        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        (p / "tokenizer_config.json").write_text(json.dumps({
            "tokenizer_class": "DnaTokenizer",
            "characters": [k for k in self.vocab if len(k) == 1],
            "model_max_length": self.model_max_length,
            "lowercase": self.lowercase,
            "vocab": self.vocab,
        }, indent=2))


def reverse_complement(seq: str) -> str:
    """String-level reverse complement (non-ACGT chars pass through)."""
    return "".join(COMPLEMENT.get(c, c) for c in reversed(seq))


def nucleotide_ids(tokenizer: "DnaTokenizer") -> List[int]:
    """Token ids for the four nucleotides in A,C,G,T order.

    The reference indexes the vocab with the lowercase literals
    (src/zero_shot_score.py:109,118) because the released tokenizers carry a
    lowercase vocab; a tokenizer loaded via from_hf_dir may instead define
    uppercase (or mixed-case) entries, so resolution here is
    case-insensitive — exact lowercase wins, then the uppercase variant —
    with a clear error naming the vocab when a base has no entry at all."""
    vocab = tokenizer.get_vocab()
    ids = []
    for n in "acgt":
        idx = vocab.get(n)
        if idx is None:
            idx = vocab.get(n.upper())
        if idx is None:
            raise KeyError(
                f"tokenizer vocab defines neither {n!r} nor {n.upper()!r} "
                f"(single-char entries: "
                f"{sorted(t for t in vocab if len(t) == 1)}) — cannot score "
                "nucleotide substitutions with it")
        ids.append(idx)
    return ids
