"""Serving runtime: batched prefill+decode driven by the log.

Requests arrive on a 'requests' topic; the server consumes them as a
consumer-group member, forms fixed-size batches, runs prefill + greedy
decode on the card, and publishes completions to a 'completions' topic.
Adding more servers = adding group members.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..core.delivery import Consumer
from ..core.log import PartitionedLog
from ..core.logstore import LogRecord
from ..data.tokenizer import ByteTokenizer
from ..models.lm import Model


@dataclass
class ServeConfig:
    batch_size: int = 4
    prompt_len: int = 64          # fixed prefill window (pad/truncate)
    max_new_tokens: int = 32
    eos_id: int = ByteTokenizer.EOS


class Server:
    """``params`` must live on ``device``; the default is the CUDA card,
    and a CUDA device without a card raises."""

    def __init__(self, model: Model, params: dict, consumer: Consumer,
                 out_log: PartitionedLog, scfg: ServeConfig,
                 device: str | torch.device = "cuda") -> None:
        self.model = model
        self.params = params
        self.consumer = consumer
        self.out_log = out_log
        self.scfg = scfg
        self.device = resolve_device(device)
        self.tok = ByteTokenizer()
        self.max_len = scfg.prompt_len + scfg.max_new_tokens
        self.served = 0

    def _batch_prompts(self, recs: list[LogRecord]
                       ) -> tuple[np.ndarray, list[str]]:
        s = self.scfg
        toks = np.full((len(recs), s.prompt_len), self.tok.PAD, np.int32)
        ids = []
        for i, rec in enumerate(recs):
            req = json.loads(rec.value)
            ids.append(str(req.get("id", i)))
            enc = self.tok.encode(req.get("prompt", ""), add_eos=False)
            enc = enc[-s.prompt_len:]
            toks[i, :len(enc)] = enc       # left-aligned, right-padded
        return toks, ids

    @torch.inference_mode()
    def generate(self, tokens: torch.Tensor) -> torch.Tensor:
        """Greedy decode of ``max_new_tokens`` after prefilling ``tokens``
        (B, prompt_len). Argmax and the cache stay on the device; the ids
        reach the host once, at the end."""
        model, params = self.model, self.params
        logits, cache = model.prefill(params, tokens, max_len=self.max_len)
        cur = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
        out = []
        for _ in range(self.scfg.max_new_tokens):
            out.append(cur)
            logits, cache = model.decode_step(params, cache, cur)
            cur = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
        return torch.cat(out, dim=1)

    def serve_once(self) -> int:
        """Poll one batch of requests, decode, publish. Returns #served."""
        s = self.scfg
        recs = self.consumer.poll(max_records=s.batch_size)
        if not recs:
            return 0
        while len(recs) < s.batch_size:   # pad batch with a copy (masked out)
            recs.append(recs[0])
        toks, req_ids = self._batch_prompts(recs)
        out_tokens = self.generate(
            torch.from_numpy(toks).to(self.device)).cpu().numpy()
        n = 0
        for i, rid in enumerate(req_ids[:len(set(req_ids))]):
            ids = out_tokens[i].tolist()
            payload = json.dumps({"id": rid, "completion_ids": ids,
                                  "text": self.tok.decode(ids)})
            self.out_log.append("completions", rid.encode(), payload.encode())
            n += 1
        self.consumer.commit()            # at-least-once for serving
        self.served += n
        return n
