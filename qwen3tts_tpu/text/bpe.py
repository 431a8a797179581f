"""GPT-2 byte-level BPE text tokenizer (reference component #3, SURVEY.md §2).

Mirrors src/text_tokenizer.cpp: byte<->unicode tables (:12-40), greedy
min-rank merge loop (:185-232), and the TTS chat template
``<|im_start|>assistant\\n{text}<|im_end|>\\n<|im_start|>assistant\\n``
(:293-330). Vocabulary and merges load straight from the HF checkpoint files
(vocab.json / merges.txt or tokenizer.json) — no GGUF round trip needed.

Pre-tokenization: the reference deliberately simplifies to space-splitting
with the space attached to the following word (:244-268, "no regex"). That is
the default here for parity; ``pretokenize="qwen2"`` enables the proper Qwen2
regex split for HF-exact tokenization of punctuation/number boundaries.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple


def bytes_to_unicode() -> Dict[int, str]:
    """The standard GPT-2 byte->unicode table (printables map to themselves,
    the rest shift up past 0x100)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(0x100 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_BYTE_TO_UNI = bytes_to_unicode()
_UNI_TO_BYTE = {v: k for k, v in _BYTE_TO_UNI.items()}

# Qwen2 pre-tokenization pattern. It needs Unicode property classes
# (\p{L}/\p{N}), which only the `regex` module has; without it the qwen2
# split is refused (TextTokenizer raises) rather than approximated.
try:
    import regex as _regex

    _QWEN2_SPLIT = _regex.compile(
        r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"""
        r""" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+""")
except ImportError:
    _QWEN2_SPLIT = None


class TextTokenizer:
    """Byte-level BPE with the reference's TTS template helpers."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: List[Tuple[str, str]],
        *,
        pretokenize: str = "space",
    ):
        self.vocab = dict(vocab)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        if pretokenize == "qwen2" and _QWEN2_SPLIT is None:
            raise ImportError(
                "pretokenize='qwen2' needs the `regex` package (Unicode "
                "\\p{L}/\\p{N} classes); install it or use 'space'")
        self.pretokenize = pretokenize
        self._cache: Dict[str, List[str]] = {}

        def find(tok: str, default: int) -> int:
            return self.vocab.get(tok, default)

        # Special ids (defaults from src/text_tokenizer.h:14-17).
        self.bos_token_id = find("<|im_start|>", 151644)
        self.eos_token_id = find("<|im_end|>", 151645)
        self.pad_token_id = find("<|endoftext|>", 151643)
        self.assistant_token_id = self.vocab.get("assistant", self.vocab.get("Ġassistant", 77091))
        self.newline_token_id = self.vocab.get("Ċ", self.vocab.get("\n", 198))

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_hf_dir(cls, model_dir: str, **kw) -> "TextTokenizer":
        vocab_path = os.path.join(model_dir, "vocab.json")
        merges_path = os.path.join(model_dir, "merges.txt")
        tok_json = os.path.join(model_dir, "tokenizer.json")
        if os.path.exists(vocab_path):
            with open(vocab_path, encoding="utf-8") as f:
                vocab = json.load(f)
            merges: List[Tuple[str, str]] = []
            if os.path.exists(merges_path):
                with open(merges_path, encoding="utf-8") as f:
                    for line in f:
                        line = line.rstrip("\n")
                        if not line or line.startswith("#"):
                            continue
                        a, _, b = line.partition(" ")
                        if b:
                            merges.append((a, b))
        elif os.path.exists(tok_json):
            with open(tok_json, encoding="utf-8") as f:
                data = json.load(f)
            vocab = data["model"]["vocab"]
            merges = []
            for m in data["model"]["merges"]:
                if isinstance(m, str):
                    a, _, b = m.partition(" ")
                else:
                    a, b = m
                merges.append((a, b))
            for added in data.get("added_tokens", []):
                vocab.setdefault(added["content"], added["id"])
        else:
            raise FileNotFoundError(f"no vocab.json or tokenizer.json under {model_dir}")
        tok = cls(vocab, merges, **kw)
        # special-token overrides from tokenizer_config.json (the reference
        # converter reads eos/pad from there, convert_tts_to_gguf.py:492-517)
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                tc = json.load(f)
            for attr, key in (("eos_token_id", "eos_token"), ("pad_token_id", "pad_token")):
                t = tc.get(key)
                if isinstance(t, dict):
                    t = t.get("content")
                if t and t in vocab:
                    setattr(tok, attr, vocab[t])
        return tok

    @classmethod
    def from_gguf(cls, reader, **kw) -> "TextTokenizer":
        """Load vocab/merges embedded in a GGUF file's metadata
        (tokenizer.ggml.tokens / tokenizer.ggml.merges, the reference's
        format: src/text_tokenizer.cpp:80-165)."""
        tokens = reader.metadata.get("tokenizer.ggml.tokens")
        if not tokens:
            raise ValueError("GGUF file carries no tokenizer vocabulary")
        vocab = {t: i for i, t in enumerate(tokens)}
        merges = []
        for m in reader.metadata.get("tokenizer.ggml.merges", []):
            a, _, b = m.partition(" ")
            if b:
                merges.append((a, b))
        tok = cls(vocab, merges, **kw)
        eos = reader.metadata.get("tokenizer.ggml.eos_token_id")
        if eos is not None:
            tok.eos_token_id = int(eos)
        pad = reader.metadata.get("tokenizer.ggml.padding_token_id")
        if pad is not None:
            tok.pad_token_id = int(pad)
        return tok

    # -- BPE ----------------------------------------------------------------

    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = list(token)
        while len(word) > 1:
            # lowest-rank adjacent pair
            best = None
            best_rank = None
            for i in range(len(word) - 1):
                r = self.bpe_ranks.get((word[i], word[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = (word[i], word[i + 1]), r
            if best is None:
                break
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i + 1 < len(word) and word[i] == best[0] and word[i + 1] == best[1]:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def _split(self, unicode_text: str) -> List[str]:
        if self.pretokenize == "qwen2":
            # regex over raw text, then byte-encode each piece
            raise AssertionError("qwen2 split handled in encode()")
        words: List[str] = []
        current = ""
        for ch in unicode_text:
            if ch == "Ġ":  # encoded space starts a new word
                if current:
                    words.append(current)
                current = ch
            else:
                current += ch
        if current:
            words.append(current)
        return words

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        if self.pretokenize == "qwen2":
            pieces = _QWEN2_SPLIT.findall(text)
            words = ["".join(_BYTE_TO_UNI[b] for b in piece.encode("utf-8")) for piece in pieces]
        else:
            unicode_text = "".join(_BYTE_TO_UNI[b] for b in text.encode("utf-8"))
            words = self._split(unicode_text)
        for word in words:
            for tok in self._bpe(word):
                tid = self.vocab.get(tok)
                if tid is not None:
                    out.append(tid)
                else:
                    # unknown merge result: fall back to per-byte tokens
                    for ch in tok:
                        bid = self.vocab.get(ch)
                        if bid is not None:
                            out.append(bid)
        return out

    def encode_for_tts(self, text: str) -> List[int]:
        """<|im_start|>assistant\\n{text}<|im_end|>\\n<|im_start|>assistant\\n"""
        head = [self.bos_token_id, self.assistant_token_id, self.newline_token_id]
        tail = [self.eos_token_id, self.newline_token_id,
                self.bos_token_id, self.assistant_token_id, self.newline_token_id]
        return head + self.encode(text) + tail

    def decode(self, ids) -> str:
        chunks = []
        for tid in ids:
            tok = self.id_to_token.get(int(tid))
            if tok is None:
                continue
            chunks.append(tok)
        text = "".join(chunks)
        # tokens not in the byte table (e.g. <|im_start|>) pass through verbatim
        out = []
        buf = bytearray()
        for ch in text:
            b = _UNI_TO_BYTE.get(ch)
            if b is not None:
                buf.append(b)
            else:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                out.append(ch)
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)


def synthetic_tokenizer(vocab_size: int = 512) -> TextTokenizer:
    """A tiny self-consistent tokenizer for tests/benches without checkpoint
    files: all 256 byte tokens, a few merges, and the Qwen special tokens at
    their (mod-vocab) canonical slots."""
    uni = [_BYTE_TO_UNI[b] for b in range(256)]
    vocab = {u: i for i, u in enumerate(uni)}
    merges = [("H", "e"), ("He", "l"), ("Hel", "l"), ("Hell", "o"),
              ("Ġ", "t"), ("Ġt", "h"), ("Ġth", "e")]
    next_id = 256
    for a, b in merges:
        vocab.setdefault(a + b, next_id)
        next_id += 1
    for special in ("<|im_start|>", "<|im_end|>", "<|endoftext|>", "assistant"):
        vocab[special] = next_id
        next_id += 1
    return TextTokenizer(vocab, merges)
