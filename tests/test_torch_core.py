"""The port's own copy of the log and consumer-group layer against the JAX
package's: the on-disk formats are byte for byte the same, so either
package reads the other's request logs and committed offsets."""
import functools
import json

import pytest

from repro.core import ConsumerGroup as JaxConsumerGroup
from repro.core import PartitionedLog as JaxPartitionedLog
from repro.core.delivery import range_assign as jax_range_assign
from repro.core.sources import corpus_documents as jax_corpus_documents
from repro_torch.core import ConsumerGroup, PartitionedLog, StaleGeneration
from repro_torch.core import log as torch_log
from repro_torch.core.delivery import range_assign
from repro_torch.core.sources import corpus_documents

SEGMENT_BYTES = 256          # small segments: the logs roll several times
JaxSmallSegmentLog = functools.partial(JaxPartitionedLog,
                                       segment_bytes=SEGMENT_BYTES)


@pytest.fixture
def small_segments(monkeypatch):
    monkeypatch.setattr(torch_log, "SEGMENT_BYTES", SEGMENT_BYTES)


def _records(n):
    return [(str(i).encode(),
             json.dumps({"id": i, "prompt": "x" * (i % 7)}).encode())
            for i in range(n)]


def _write(log, recs):
    log.create_topic("requests", partitions=4)
    log.append_batch("requests", recs[:20])        # key-routed batch
    log.append_batch("requests", recs[20:30], partition=2)
    for k, v in recs[30:]:
        log.append("requests", k, v)
    log.close()


def _read_all(log):
    return [(r.partition, r.offset, r.key, r.value)
            for p in range(log.num_partitions("requests"))
            for r in log.read("requests", p, 0, 1000)]


@pytest.mark.parametrize("writer,reader", [
    (JaxSmallSegmentLog, PartitionedLog),
    (PartitionedLog, JaxSmallSegmentLog),
], ids=["jax-to-port", "port-to-jax"])
def test_request_log_crosses_packages(tmp_path, small_segments, writer,
                                      reader):
    recs = _records(40)
    _write(writer(tmp_path / "log"), recs)
    log = reader(tmp_path / "log")
    got = _read_all(log)
    log.close()
    assert sorted((k, v) for _, _, k, v in got) == sorted(recs)
    assert len(list((tmp_path / "log" / "requests" / "2").glob("*.seg"))) > 1


def test_segment_files_are_byte_identical(tmp_path, small_segments):
    recs = _records(40)
    _write(JaxSmallSegmentLog(tmp_path / "a"), recs)
    _write(PartitionedLog(tmp_path / "b"), recs)
    a = sorted(p.relative_to(tmp_path / "a")
               for p in (tmp_path / "a").rglob("*.seg"))
    b = sorted(p.relative_to(tmp_path / "b")
               for p in (tmp_path / "b").rglob("*.seg"))
    assert a == b
    for rel in a:
        assert (tmp_path / "a" / rel).read_bytes() == \
            (tmp_path / "b" / rel).read_bytes()


def test_torn_tail_is_truncated_on_reopen(tmp_path):
    log = PartitionedLog(tmp_path / "log")
    log.create_topic("t", partitions=1)
    log.append_batch("t", [(b"k", b"v1"), (b"k", b"v2")])
    log.close()
    seg = next((tmp_path / "log" / "t" / "0").glob("*.seg"))
    with open(seg, "ab") as f:
        f.write(b"\x01\x02\x03 torn")
    log = PartitionedLog(tmp_path / "log")
    assert [r.value for r in log.read("t", 0, 0)] == [b"v1", b"v2"]
    assert log.append("t", b"k", b"v3") == (0, 2)
    log.close()


def test_committed_offsets_cross_packages(tmp_path):
    """A group member of one package commits; a member of the other
    resumes after it (same offsets file, same format)."""
    _write(PartitionedLog(tmp_path / "log"), _records(40))
    log = PartitionedLog(tmp_path / "log")
    c = ConsumerGroup(log, "requests", "servers").add_member("m")
    first = c.poll(max_records=12)
    c.commit()
    log.close()
    jlog = JaxPartitionedLog(tmp_path / "log")
    rest = JaxConsumerGroup(jlog, "requests", "servers").add_member("m").poll(
        max_records=1000)
    jlog.close()
    seen = [(r.partition, r.offset) for r in first + rest]
    assert len(first) == 12 and len(seen) == len(set(seen)) == 40


def test_consumer_group_rebalance_and_generation(tmp_path):
    log = PartitionedLog(tmp_path / "log")
    log.create_topic("requests", partitions=4)
    grp = ConsumerGroup(log, "requests", "g")
    a = grp.add_member("a")
    assert a.assignment == [0, 1, 2, 3]
    b = grp.add_member("b")
    assert (a.assignment, b.assignment) == ([0, 1], [2, 3])
    grp.remove_member("b")
    assert a.assignment == [0, 1, 2, 3]
    with pytest.raises(StaleGeneration):
        b.poll()
    for parts, members in ((4, ["b", "a"]), (5, ["x", "y", "z"]), (2, [])):
        assert range_assign(parts, members) == \
            jax_range_assign(parts, members)
    log.close()


def test_corpus_matches_jax():
    assert list(corpus_documents(5, seed=11)) == \
        list(jax_corpus_documents(5, seed=11))
