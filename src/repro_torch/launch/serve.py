"""Serving launcher: consume the 'requests' topic, publish 'completions'.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --requests 16 --batch 8 --prompt-len 256 --max-new 64

Runs on the CUDA card by default; ``--device cpu`` runs the kernels' plain
versions on the CPU. Weights are random, from ``--seed``.
"""
from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import torch

from .. import configs, resolve_device
from ..core import ConsumerGroup, PartitionedLog
from ..core.sources import corpus_documents
from ..models import Model
from ..runtime import ServeConfig, Server


def enqueue_requests(log: PartitionedLog, n: int) -> None:
    """The launcher's request stream: ``n`` prompts cut from the seeded
    corpus onto a 4-partition 'requests' topic, keyed by request id."""
    log.create_topic("requests", partitions=4)
    log.create_topic("completions", partitions=4)
    log.append_batch("requests", [
        (str(i).encode(), json.dumps({"id": i, "prompt": doc[:80]}).encode())
        for i, doc in enumerate(corpus_documents(n, seed=11))])


def serve(root: Path, arch: str, reduced: bool, requests: int, batch: int,
          prompt_len: int, max_new: int, device: torch.device,
          seed: int) -> tuple[int, int]:
    """Serve every request; returns (served, completions landed)."""
    cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    log = PartitionedLog(root / "log")
    try:
        enqueue_requests(log, requests)
        model = Model(cfg)
        params = model.init(torch.Generator(device).manual_seed(seed), device)
        grp = ConsumerGroup(log, "requests", "servers")
        server = Server(model, params, grp.add_member("srv0"), log,
                        ServeConfig(batch_size=batch, prompt_len=prompt_len,
                                    max_new_tokens=max_new), device=device)
        while server.serve_once():
            pass
        return server.served, sum(log.end_offsets("completions"))
    finally:
        log.close()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=list(configs.ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="serve_") as tmp:
        root = Path(args.workdir or tmp)
        served, done = serve(root, args.arch, args.reduced, args.requests,
                             args.batch, args.prompt_len, args.max_new,
                             device, args.seed)
    print(f"served {served}, completions landed: {done}")


if __name__ == "__main__":
    main()
