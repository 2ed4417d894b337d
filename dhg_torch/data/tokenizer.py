"""Character tokenizer for handwriting prompts (the port's own copy of
dhg/data/tokenizer.py).

  * charset "_" + ascii_letters + digits + ".?!,'\"- " (71 chars) -> ids 2..72;
  * id 0 = padding, id 1 = end-of-sentence;
  * unknown characters map to id 2 ("_");
  * encode() appends EOS; vocab_size = 73.
"""

from __future__ import annotations

import string

import numpy as np

CHARSET = "_" + string.ascii_letters + string.digits + ".?!,'\"- "
PAD_ID = 0
EOS_ID = 1
UNK_ID = 2  # '_'
VOCAB_SIZE = len(CHARSET) + 2


class Tokenizer:
    def __init__(self):
        self.tokens = {c: i + 2 for i, c in enumerate(CHARSET)}
        self.vocab_size = VOCAB_SIZE

    def encode(self, text: str) -> list[int]:
        """Encode a string to token ids, appending EOS."""
        return [self.tokens.get(c, UNK_ID) for c in text] + [EOS_ID]

    def encode_batch(self, texts: list[str], max_len: int) -> np.ndarray:
        """[B, max_len] int64 ids, each row EOS-terminated and zero-padded."""
        out = np.zeros((len(texts), max_len), dtype=np.int64)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            if len(ids) > max_len:
                raise ValueError(f"text too long at row {i}: {len(ids)} > {max_len}")
            out[i, : len(ids)] = ids
        return out
