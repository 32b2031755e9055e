"""The port's serving runtime and launcher on the CPU: the JAX Server and
the port's Server give identical completions from their own logs on the
same float32 params, for tinyllama and mamba2; the port of
tests/test_serve_runtime.py; and the entry points refuse to run on a card
that is not there."""
import json

import pytest
import torch

from repro.core import ConsumerGroup as JaxConsumerGroup
from repro.core import PartitionedLog as JaxPartitionedLog
from repro.runtime import ServeConfig as JaxServeConfig
from repro.runtime import Server as JaxServer
from repro_torch import configs
from repro_torch.core import ConsumerGroup, PartitionedLog
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model
from repro_torch.runtime import ServeConfig, Server
from torch_parity import reduced_pair


def _requests(log, n):
    log.create_topic("requests", partitions=4)
    log.create_topic("completions", partitions=2)
    for i in range(n):
        log.append("requests", str(i).encode(),
                   json.dumps({"id": i, "prompt": f"request number {i}"})
                   .encode())


def _completions(log):
    return {d["id"]: d for d in (
        json.loads(r.value) for p in range(log.num_partitions("completions"))
        for r in log.read("completions", p, 0, 100))}


def _port_setup(tmp_path, n_requests=6):
    log = PartitionedLog(tmp_path / "log")
    _requests(log, n_requests)
    cfg = configs.get_reduced("tinyllama-1.1b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    return log, model, params


def _server_parity(tmp_path, arch: str, prompt_len: int) -> None:
    """Same 6 requests, same float32 params: identical completion ids."""
    _, jmodel, jparams, tcfg, tparams = reduced_pair(arch=arch)
    jlog = JaxPartitionedLog(tmp_path / "jax")
    tlog = PartitionedLog(tmp_path / "port")
    _requests(jlog, 6)
    _requests(tlog, 6)
    jsrv = JaxServer(jmodel, jparams,
                     JaxConsumerGroup(jlog, "requests", "s").add_member("a"),
                     jlog, JaxServeConfig(batch_size=4,
                                          prompt_len=prompt_len,
                                          max_new_tokens=6))
    tsrv = Server(Model(tcfg), tparams,
                  ConsumerGroup(tlog, "requests", "s").add_member("a"), tlog,
                  ServeConfig(batch_size=4, prompt_len=prompt_len,
                              max_new_tokens=6),
                  device="cpu")
    while jsrv.serve_once():
        pass
    while tsrv.serve_once():
        pass
    want, got = _completions(jlog), _completions(tlog)
    assert len(got) == 6 and got.keys() == want.keys()
    for rid in want:
        assert got[rid]["completion_ids"] == want[rid]["completion_ids"]
        assert got[rid]["text"] == want[rid]["text"]
    jlog.close()
    tlog.close()


def test_port_server_matches_jax_server(tmp_path):
    _server_parity(tmp_path, "tinyllama-1.1b", 16)


def test_port_server_matches_jax_server_mamba2(tmp_path):
    """The prompts are right-padded, so mamba2 runs its SSM over the PAD
    tokens before decoding, on both sides."""
    _server_parity(tmp_path, "mamba2-370m", 40)


def test_server_serves_all_requests(tmp_path):
    log, model, params = _port_setup(tmp_path)
    grp = ConsumerGroup(log, "requests", "servers")
    srv = Server(model, params, grp.add_member("s0"), log,
                 ServeConfig(batch_size=4, prompt_len=16, max_new_tokens=4),
                 device="cpu")
    while srv.serve_once():
        pass
    assert sum(log.end_offsets("completions")) == 6
    done = _completions(log)
    assert len(done) == 6
    for doc in done.values():
        assert len(doc["completion_ids"]) == 4
    log.close()


def test_two_servers_split_partitions(tmp_path):
    """Elastic serving: a second member takes half the request partitions."""
    log, model, params = _port_setup(tmp_path, n_requests=8)
    grp = ConsumerGroup(log, "requests", "servers")
    c0 = grp.add_member("s0")
    c1 = grp.add_member("s1")
    assert sorted(c0.assignment + c1.assignment) == [0, 1, 2, 3]
    total = 0
    for c in (c0, c1):
        srv = Server(model, params, c, log,
                     ServeConfig(batch_size=4, prompt_len=16,
                                 max_new_tokens=2), device="cpu")
        while n := srv.serve_once():
            total += n
    assert total == 8
    log.close()


def test_launcher_serves_on_cpu(tmp_path, capsys):
    launch_serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                       "--batch", "2", "--prompt-len", "16", "--max-new",
                       "3", "--workdir", str(tmp_path)])
    assert "served 3, completions landed: 3" in capsys.readouterr().out


def test_launcher_serves_mamba2_on_cpu(tmp_path, capsys):
    launch_serve.main(["--arch", "mamba2-370m", "--reduced", "--device",
                       "cpu", "--requests", "5", "--batch", "2",
                       "--prompt-len", "20", "--max-new", "3", "--workdir",
                       str(tmp_path)])
    assert "served 5, completions landed: 5" in capsys.readouterr().out


def test_cuda_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA entry points would run")
    cfg = configs.get_reduced("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch_serve.main(["--reduced", "--requests", "1",
                           "--workdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Model(cfg).init(torch.Generator().manual_seed(0))
    log, model, params = _port_setup(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Server(model, params,
               ConsumerGroup(log, "requests", "g").add_member("m"), log,
               ServeConfig())
    log.close()
