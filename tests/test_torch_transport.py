"""The port's shared-memory transport against the JAX package's: frames
encoded by either package are the same bytes and decode in the other, a
ring made by either is read by the other through its segment name, and a
keyed stream fed through the port's ring fires the JAX package's windows
bitwise. Then the transport's own contracts, as the JAX package's tests
hold them: ring mechanics and slot epochs (a reclaimed slot is refused,
never read as recycled bytes), the columnar codec (hypothesis properties
included), the broker's batch path and its copy-out where a slot cannot
serve (rf > 1, an oversized frame), consumer-progress reclaim and replay
floors, ring backpressure feeding ``io_stall_seconds``, segments unlinked
on teardown, views crossing processes, both engines on ``transport="shm"``,
the detector source and the spec's transport fields."""
import multiprocessing as mp
import pickle
import threading
import time
from multiprocessing import shared_memory

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.transport as jax_transport
from repro.broker import BrokerCluster as JaxCluster, Producer as JaxProducer
from repro.engines.continuous import ContinuousStream as JaxContinuous
from repro.streaming import TumblingWindow as JaxTumbling
from repro_torch.broker.cluster import BrokerCluster
from repro_torch.broker.consumer import Consumer, ConsumerGroup
from repro_torch.broker.log import PartitionLog
from repro_torch.broker.producer import Producer
from repro_torch.broker.records import Record
from repro_torch.engines.continuous import ContinuousStream
from repro_torch.engines.microbatch import MicroBatchStream
from repro_torch.streaming import TumblingWindow
from repro_torch.transport import (
    RingTimeout,
    SharedMemoryRing,
    ShmArrayView,
    ShmTransport,
    SlotReclaimedError,
    decode_frame,
    encode_slot_record,
    pack_frame,
)
from repro_torch.transport import ring as ring_mod

torch.set_num_threads(1)


def shm_cluster(topic="t", *, n_parts=1, slot_bytes=1 << 20, n_slots=16,
                replication_factor=1, n_nodes=1):
    cluster = BrokerCluster(n_nodes)
    transport = ShmTransport(slot_bytes=slot_bytes, n_slots=n_slots)
    cluster.attach_transport(transport)
    cluster.create_topic(topic, n_parts, replication_factor=replication_factor)
    transport.mount(topic)
    return cluster, transport


@pytest.fixture
def shm_setup():
    cluster, transport = shm_cluster()
    yield cluster, transport
    cluster.close()


MIXED = [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.ones((3, 4), dtype=np.float32) * 7,       # same group
    np.arange(5, dtype=np.int64),                # second group
    b"raw-bytes",                                # fallback: bytes
    np.float64(3.5),                             # fallback: 0-d
]


# -- across the packages -------------------------------------------------------------


def test_frames_cross_between_the_packages_byte_for_byte():
    """The same batch packs to the same bytes in both packages, and each
    decodes the other's frame to the same values."""
    ts = [10.0, 11.0, 12.0, 13.0, 14.0]
    uniform = [np.full((360, 16), i, dtype=np.float32) for i in range(8)]
    for vals, stamps, key in ((MIXED, ts, b"k7"), (uniform, None, None)):
        ours = pack_frame(vals, stamps, key=key)
        theirs = jax_transport.pack_frame(vals, stamps, key=key)
        assert ours == theirs
        for frame in (decode_frame(theirs), jax_transport.decode_frame(ours)):
            assert frame.timestamps == stamps and frame.key == key
            for got, want in zip(frame.values, vals):
                if isinstance(want, bytes):
                    assert got == want
                else:
                    assert np.asarray(got).dtype == np.asarray(want).dtype
                    assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
    assert encode_slot_record("rring-x", 3, 5, 7) == \
        jax_transport.encode_slot_record("rring-x", 3, 5, 7)


def test_a_ring_made_by_either_package_is_read_by_the_other():
    for maker, reader in ((SharedMemoryRing, jax_transport.SharedMemoryRing),
                          (jax_transport.SharedMemoryRing, SharedMemoryRing)):
        ring = maker(slot_bytes=256, n_slots=2)
        try:
            slot, epoch = ring.alloc()
            frame = pack_frame([np.arange(8, dtype=np.int32)])
            ring.write(slot, epoch, [frame])
            other = reader.attach(ring.name)
            assert bytes(other.view(slot, epoch)) == frame
            ring.release(slot, epoch)  # reclaimed: the epoch no longer matches
            with pytest.raises(Exception, match="reclaimed"):
                other.view(slot, epoch)
            other.close()
        finally:
            ring.destroy()


def _keyed_run(pkg: str, transport: str) -> dict:
    """300 records ((b*10 + j) mod 3 keys) in 30 batches of 10 through one
    partition into 0.1 s tumbling windows: {(key, window): (sum, count)}."""
    if transport == "shm":
        cluster, _ = shm_cluster("cw")
    else:
        cluster = (JaxCluster if pkg == "jax" else BrokerCluster)(1)
        cluster.create_topic("cw", 1)
    results = {}
    stream = (JaxContinuous if pkg == "jax" else ContinuousStream)(
        cluster, "cw", group="g", assigner=(JaxTumbling if pkg == "jax" else TumblingWindow)(0.1),
        window_fn=lambda key, w, msgs: (key, w, float(np.sum([m.value[1] for m in msgs])),
                                        len(msgs)),
        key_fn=lambda m: int(m.value[0]),
        emit=lambda out: results.__setitem__((out[0], out[1]), (out[2], out[3])),
        transport=transport)
    stream.start()
    prod = (JaxProducer if pkg == "jax" else Producer)(cluster, "cw")
    for b in range(30):
        vals = [np.array([(b * 10 + j) % 3, float(b * 10 + j) * 1.25]) for j in range(10)]
        ts = [1000.0 + (b * 10 + j) * 0.01 for j in range(10)]
        prod.send_batch(vals, key=b"k", timestamps=ts)
    stream.await_windows((int(300 * 0.01 / 0.1) - 1) * 3, timeout=20)
    stream.stop()
    if transport == "shm":
        assert cluster.transport.ring_for("cw").alloc_count == 30
    cluster.close()
    return results


def test_continuous_windows_over_the_ring_equal_the_jax_package():
    """The port's engine on the ring (frames copied out) and on the log
    fires the JAX package's log run, bitwise."""
    theirs = _keyed_run("jax", "log")
    assert _keyed_run("torch", "shm") == theirs
    assert _keyed_run("torch", "log") == theirs


# -- ring mechanics ---------------------------------------------------------------


def test_ring_alloc_write_view_release_roundtrip():
    ring = SharedMemoryRing(slot_bytes=256, n_slots=4)
    try:
        slot, epoch = ring.alloc()
        assert epoch % 2 == 1  # odd = live
        assert ring.free_slots == 3
        ring.write(slot, epoch, [b"hello transport"])
        assert bytes(ring.view(slot, epoch)) == b"hello transport"
        ring.release(slot, epoch)
        assert ring.free_slots == 4 and not ring.is_valid(slot, epoch)
        with pytest.raises(SlotReclaimedError):
            ring.view(slot, epoch)
    finally:
        ring.destroy()


def test_ring_write_rejects_oversized_frames():
    ring = SharedMemoryRing(slot_bytes=16, n_slots=2)
    try:
        slot, epoch = ring.alloc()
        with pytest.raises(ValueError):
            ring.write(slot, epoch, [b"x" * 32])
    finally:
        ring.destroy()


def test_ring_exhaustion_stalls_then_times_out():
    ring = SharedMemoryRing(slot_bytes=64, n_slots=2)
    try:
        ring.alloc()
        ring.alloc()
        t0 = time.monotonic()
        with pytest.raises(RingTimeout):
            ring.alloc(deadline=time.monotonic() + 0.15)
        assert time.monotonic() - t0 >= 0.1
        assert ring.stall_seconds > 0  # backpressure is observable
    finally:
        ring.destroy()


def test_ring_reader_refcount_defers_reclaim():
    ring = SharedMemoryRing(slot_bytes=64, n_slots=2)
    try:
        slot, epoch = ring.alloc()
        ring.write(slot, epoch, [b"pinned"])
        assert ring.retain(slot, epoch)
        ring.release(slot, epoch)  # producer done, but a reader holds it
        assert ring.is_valid(slot, epoch) and ring.free_slots == 1
        ring.release_ref(slot, epoch)  # last reader out -> reclaimed
        assert not ring.is_valid(slot, epoch) and ring.free_slots == 2
    finally:
        ring.destroy()


def test_ring_attach_by_name_is_self_describing():
    ring = SharedMemoryRing(slot_bytes=128, n_slots=3)
    try:
        slot, epoch = ring.alloc()
        ring.write(slot, epoch, [b"cross-handle"])
        other = SharedMemoryRing.attach(ring.name)
        assert (other.slot_bytes, other.n_slots) == (128, 3)
        assert bytes(other.view(slot, epoch)) == b"cross-handle"
        other.close()
    finally:
        ring.destroy()


def test_ring_refuses_what_dev_shm_cannot_hold(monkeypatch):
    """A ring larger than the free space of ``/dev/shm`` fails at mount with
    both numbers named (a write past that tmpfs would SIGBUS the writer)."""
    monkeypatch.setattr(ring_mod.shutil, "disk_usage",
                        lambda path: type("U", (), {"free": 1000})())
    with pytest.raises(RuntimeError, match=r"4 slots x 512 B = 2048 B.*1000 B free"):
        SharedMemoryRing(slot_bytes=512, n_slots=4)
    transport = ShmTransport(slot_bytes=512, n_slots=4)
    with pytest.raises(RuntimeError, match="/dev/shm"):
        transport.mount("t")
    assert not transport.serves("t")


# -- frame serde ---------------------------------------------------------------


def test_frame_roundtrip_mixed_payloads():
    ts = [10.0, 11.0, 12.0, 13.0, 14.0]
    frame = decode_frame(pack_frame(MIXED, ts, key=b"k7"))
    assert frame.timestamps == ts and frame.key == b"k7"
    for i in range(3):
        assert np.array_equal(frame.values[i], MIXED[i])
    assert frame.values[3] == b"raw-bytes"
    assert float(frame.values[4]) == 3.5


def test_frame_roundtrip_structured_dtype():
    dt = np.dtype([("id", "<u4"), ("pos", "<f8", (3,)), ("flag", "?")])
    rows = np.zeros(4, dtype=dt)
    rows["id"] = [1, 2, 3, 4]
    rows["pos"] = np.arange(12).reshape(4, 3)
    rows["flag"] = [True, False, True, False]
    frame = decode_frame(pack_frame([rows, rows]))
    assert frame.values[0].dtype == dt  # dtype.str would have lost the fields
    assert np.array_equal(frame.values[1], rows)


def test_frame_zero_copy_views_alias_the_buffer():
    vals = [np.full((8,), i, dtype=np.int32) for i in range(4)]
    buf = bytearray(pack_frame(vals))
    raw = np.frombuffer(buf, dtype=np.uint8)
    zc = decode_frame(buf, zero_copy=True)
    co = decode_frame(buf, zero_copy=False)
    for v in zc.values:
        assert np.shares_memory(raw, v)  # true views, zero serde copies
    for v in co.values:
        assert not np.shares_memory(raw, v)  # default is detached copies
    for a, b in zip(zc.values, co.values):
        assert np.array_equal(a, b)


def test_zero_copy_view_across_reclaim_is_detected_not_corrupted(shm_setup):
    """A consumer holding zero-copy views across a slot reclaim gets an
    epoch-mismatch error on verify, not silently recycled bytes."""
    cluster, transport = shm_setup
    ring = transport.ring_for("t")
    prod = Producer(cluster, "t")
    cons = Consumer(cluster, ConsumerGroup(cluster, "g", "t"), "m0", zero_copy=True)
    prod.send_batch([np.arange(64, dtype=np.float64)])
    [batch] = cons.poll_batch(timeout=1.0)
    view = batch.values[0]
    assert isinstance(view, ShmArrayView)
    batch.frame.verify()  # still live: fine
    cons.commit()          # advances the reclaim floor past the frame
    assert ring.free_slots == ring.n_slots, "commit should reclaim the slot"
    with pytest.raises(SlotReclaimedError):
        batch.frame.verify()
    with pytest.raises(SlotReclaimedError):
        view.verify()


# -- hypothesis properties of the codec, across the packages ----------------------------

SIMPLE_DTYPES = st.sampled_from(["<u1", "<u2", "<i4", "<i8", "<f4", "<f8", "<c8", "?"])
STRUCTURED_DTYPES = st.sampled_from([
    np.dtype([("id", "<u4"), ("x", "<f8")]),
    np.dtype([("id", "<u4"), ("pos", "<f8", (3,)), ("flag", "?")]),
    np.dtype([("a", "<i2"), ("b", [("c", "<f4"), ("d", "<u1")])]),
])
SHAPES = st.sampled_from([(0,), (1,), (7,), (3, 4), (2, 3, 2), (16, 16)])


@st.composite
def arrays(draw):
    if draw(st.booleans()):
        dt = np.dtype(draw(SIMPLE_DTYPES))
        shape = draw(SHAPES)
        n = int(np.prod(shape))
        raw = draw(st.binary(min_size=n * dt.itemsize, max_size=n * dt.itemsize))
        arr = np.frombuffer(raw, dtype=dt).reshape(shape).copy()
    else:
        dt = draw(STRUCTURED_DTYPES)
        n = draw(st.integers(min_value=0, max_value=8))
        arr = np.zeros(n, dtype=dt)
        if n and dt.names:
            arr[dt.names[0]] = np.arange(n).astype(arr[dt.names[0]].dtype)
    # non-contiguous and Fortran-ordered inputs: the encoder normalizes
    # layout without changing content
    variant = draw(st.integers(min_value=0, max_value=2))
    if variant == 1 and arr.ndim >= 2:
        arr = np.asfortranarray(arr)
    elif variant == 2 and arr.ndim >= 1 and arr.shape[0] >= 2:
        arr = arr[::2]
    return arr


def _same(got, want) -> bool:
    if isinstance(want, bytes):
        return got == want
    # byte-exact: random float payloads hold NaNs, which array_equal rejects
    return (got.dtype == want.dtype and got.shape == want.shape
            and np.ascontiguousarray(got).tobytes() == np.ascontiguousarray(want).tobytes())


@settings(max_examples=200, deadline=None)
@given(values=st.lists(st.one_of(arrays(), st.binary(max_size=64)), max_size=12),
       with_ts=st.booleans(), key=st.one_of(st.none(), st.binary(min_size=1, max_size=16)))
def test_frame_roundtrip_is_lossless(values, with_ts, key):
    """Lossless in the port, and the same bytes as the JAX package's
    encoding, which the port decodes as well."""
    ts = [float(i) * 0.5 for i in range(len(values))] if with_ts else None
    packed = pack_frame(values, ts, key=key)
    assert packed == jax_transport.pack_frame(values, ts, key=key)
    for frame in (decode_frame(packed), jax_transport.decode_frame(packed)):
        assert len(frame) == len(values) and frame.timestamps == ts and frame.key == key
        assert all(_same(g, w) for g, w in zip(frame.values, values))


@settings(max_examples=100, deadline=None)
@given(values=st.lists(arrays(), min_size=1, max_size=8))
def test_zero_copy_decode_matches_copy_out(values):
    buf = pack_frame(values)
    zc = decode_frame(bytearray(buf), zero_copy=True)
    co = decode_frame(buf)
    assert all(_same(a, b) for a, b in zip(zc.values, co.values))


@settings(max_examples=100, deadline=None)
@given(rows=st.integers(min_value=0, max_value=16), dt=STRUCTURED_DTYPES)
def test_structured_dtype_fields_survive_the_wire(rows, dt):
    arr = np.zeros(rows, dtype=dt)
    for frame in (decode_frame(pack_frame([arr, arr])),
                  decode_frame(jax_transport.pack_frame([arr, arr]))):
        for got in frame.values:
            # dtype equality is field-exact: names, nested formats, subshapes
            assert got.dtype == dt and np.array_equal(got, arr)


# -- broker batch path -----------------------------------------------------------


def test_append_many_single_batch_offsets_and_stats():
    log = PartitionLog("t", 0)
    offsets = log.append_many([Record(bytes([i]) * 4) for i in range(8)])
    assert offsets == list(range(8))
    assert log.stats.appended_records == 8 and log.high_watermark == 8
    assert [r.offset for r in log.read(0, 100)] == offsets


def test_append_many_drop_policy_marks_holes():
    log = PartitionLog("t", 0, max_buffer_bytes=10, backpressure="drop")
    assert log.append_many([Record(b"x" * 4) for _ in range(4)]) == [0, 1, -1, -1]
    assert log.stats.dropped_records == 2


def test_send_batch_shm_uses_one_slot_and_tiny_records(shm_setup):
    cluster, transport = shm_setup
    ring = transport.ring_for("t")
    prod = Producer(cluster, "t")
    vals = [np.arange(256, dtype=np.float32) + i for i in range(20)]
    offsets = prod.send_batch(vals, key=b"k", timestamps=[float(i) for i in range(20)])
    assert offsets == list(range(20))
    assert ring.used_slots == 1  # 20 messages, one payload write
    assert prod.copied_out_records == 0
    recs = cluster.topic("t").partitions[0].read(0, 100)
    assert all(r.value[:1] == b"S" for r in recs)
    assert all(len(r.value) < 100 for r in recs)  # control plane only
    msgs = Consumer(cluster, ConsumerGroup(cluster, "g", "t"), "m0").poll(
        max_records=64, timeout=1.0)
    assert len(msgs) == 20 and msgs[5].timestamp == 5.0
    for m, v in zip(msgs, vals):
        assert np.array_equal(m.value, v)
        assert not isinstance(m.value, ShmArrayView)  # default = copy-out


def test_send_batch_replicated_topic_copies_out():
    cluster, transport = shm_cluster("rep", replication_factor=2, n_nodes=2)
    try:
        vals = [np.arange(16, dtype=np.int32) * i for i in range(5)]
        prod = Producer(cluster, "rep")
        prod.send_batch(vals)
        assert transport.ring_for("rep").used_slots == 0  # rf>1: inline
        assert prod.copied_out_records == 5
        msgs = Consumer(cluster, ConsumerGroup(cluster, "g", "rep"), "m0").poll(timeout=1.0)
        assert len(msgs) == 5
        for m, v in zip(msgs, vals):
            assert np.array_equal(m.value, v)
    finally:
        cluster.close()


def test_send_batch_oversized_frame_falls_back_inline():
    cluster, transport = shm_cluster("small", slot_bytes=1024)
    try:
        vals = [np.zeros(4096, dtype=np.float64)]  # 32KB >> 1KB slot
        prod = Producer(cluster, "small")
        prod.send_batch(vals)
        assert transport.ring_for("small").used_slots == 0 and prod.copied_out_records == 1
        [m] = Consumer(cluster, ConsumerGroup(cluster, "g", "small"), "m0").poll(timeout=1.0)
        assert np.array_equal(m.value, vals[0])
    finally:
        cluster.close()


def test_poll_batch_groups_by_frame(shm_setup):
    cluster, _ = shm_setup
    prod = Producer(cluster, "t")
    prod.send_batch([np.ones(8, dtype=np.float32) * i for i in range(6)])
    prod.send_batch([np.ones(8, dtype=np.float32) * i for i in range(4)])
    cons = Consumer(cluster, ConsumerGroup(cluster, "g", "t"), "m0")
    batches = cons.poll_batch(timeout=1.0, zero_copy=True)
    assert [len(b) for b in batches] == [6, 4]
    assert batches[0].offsets == list(range(6)) and batches[1].offsets == list(range(6, 10))
    assert float(batches[1].values[3][0]) == 3.0
    for b in batches:
        b.frame.verify()


# -- reclaim: commit floors, replay floors, backpressure ---------------------------


def test_slowest_group_pins_the_reclaim_floor(shm_setup):
    cluster, transport = shm_setup
    ring = transport.ring_for("t")
    prod = Producer(cluster, "t")
    fast = Consumer(cluster, ConsumerGroup(cluster, "fast", "t"), "f0")
    slow = Consumer(cluster, ConsumerGroup(cluster, "slow", "t"), "s0")
    for i in range(3):
        prod.send_batch([np.arange(32, dtype=np.float64) + i])
    assert ring.used_slots == 3
    fast.poll(timeout=1.0)
    fast.commit()
    assert ring.used_slots == 3  # the slow group has registered but not committed
    slow.poll(timeout=1.0)
    slow.commit()
    assert ring.used_slots == 0


def test_replay_floor_holds_slots_past_commits(shm_setup):
    cluster, transport = shm_setup
    ring = transport.ring_for("t")
    prod = Producer(cluster, "t")
    cons = Consumer(cluster, ConsumerGroup(cluster, "g", "t"), "m0")
    cluster.set_replay_floor("g", "t", {0: 0})  # a checkpointing stream's horizon
    for i in range(3):
        prod.send_batch([np.arange(32, dtype=np.float64) + i])
    cons.poll(timeout=1.0)
    cons.commit()
    assert ring.used_slots == 3, "commit must not reclaim below the replay floor"
    cluster.set_replay_floor("g", "t", {0: 3})  # ... until the next checkpoint
    assert ring.used_slots == 0


def test_full_ring_backpressure_stalls_producer_and_feeds_io_stall():
    cluster, transport = shm_cluster("bp", slot_bytes=4096, n_slots=2)
    try:
        prod = Producer(cluster, "bp", send_timeout=5.0)
        cons = Consumer(cluster, ConsumerGroup(cluster, "g", "bp"), "m0")
        base_stall = cluster.io_stall_seconds()
        for _ in range(2):
            prod.send_batch([np.arange(64, dtype=np.float64)])
        done = threading.Event()

        def produce_third():
            prod.send_batch([np.arange(64, dtype=np.float64)])
            done.set()

        threading.Thread(target=produce_third, daemon=True).start()
        assert not done.wait(0.3), "the third batch should stall on the full ring"
        cons.poll(timeout=1.0)
        cons.commit()  # frees slots -> the stalled producer completes
        assert done.wait(5.0)
        assert cluster.io_stall_seconds() > base_stall  # the elasticity signal
    finally:
        cluster.close()


def test_transport_unmount_unlinks_segment(shm_setup):
    cluster, transport = shm_setup
    name = transport.ring_for("t").name
    cluster.delete_topic("t")
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name)


def test_broker_pilot_cancel_cleans_up_segments():
    from repro_torch.core import PilotComputeService

    svc = PilotComputeService(devices=[torch.device("cpu")] * 2)
    cluster = svc.submit_pilot({"number_of_nodes": 1, "type": "kafka"}).get_context()
    transport = ShmTransport(n_slots=4)
    cluster.attach_transport(transport)
    cluster.create_topic("x", 1)
    transport.mount("x")
    name = transport.ring_for("x").name
    svc.cancel()
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name)


# -- producer rate limiter --------------------------------------------------------


def test_rate_limiter_sleeps_outside_the_lock(monkeypatch):
    cluster = BrokerCluster(1)
    cluster.create_topic("r", 1)
    # 20 msgs/s: the second send's slot is 50 ms away, so it waits even on
    # a loaded host
    prod = Producer(cluster, "r", rate_msgs_per_s=20.0)
    held = []
    real_sleep = time.sleep
    monkeypatch.setattr(time, "sleep", lambda seconds: held.append(prod._lock.locked()))
    prod.send(np.zeros(4))
    prod.send(np.zeros(4))  # the second send waits for its slot
    monkeypatch.setattr(time, "sleep", real_sleep)
    assert held, "the limiter never slept"
    assert not any(held), "a rate-limit sleep under Producer._lock serializes all senders"


def test_rate_limiter_paces_batches_by_element_count():
    cluster = BrokerCluster(1)
    cluster.create_topic("r", 1)
    prod = Producer(cluster, "r", rate_msgs_per_s=1000.0)
    t0 = time.monotonic()
    for _ in range(5):
        prod.send_batch([np.zeros(4) for _ in range(20)])
    # 100 msgs at 1000/s span >= ~80 ms though there were 5 batch calls
    assert time.monotonic() - t0 >= 0.08


# -- cross-process: workers attach to the segment by name ---------------------------


def _child_read_view(pickled, q):
    try:
        view = pickle.loads(pickled)  # reattaches the segment by name
        q.put(("sum", float(np.asarray(view).sum())))
        q.put(("valid", True))
    except SlotReclaimedError:
        q.put(("reclaimed", True))
    except Exception as exc:  # pragma: no cover
        q.put(("error", repr(exc)))


def _child_read_reclaimed(pickled, q):
    try:
        pickle.loads(pickled)
        q.put(("error", "reattach of a reclaimed slot succeeded"))
    except SlotReclaimedError:
        q.put(("reclaimed", True))
    except Exception as exc:  # pragma: no cover
        q.put(("error", repr(exc)))


def test_worker_process_attaches_view_by_name(shm_setup):
    cluster, _ = shm_setup
    prod = Producer(cluster, "t")
    cons = Consumer(cluster, ConsumerGroup(cluster, "g", "t"), "m0", zero_copy=True)
    arr = np.arange(128, dtype=np.float64)
    prod.send_batch([arr])
    [batch] = cons.poll_batch(timeout=1.0)
    payload = pickle.dumps(batch.values[0])
    assert len(payload) < 512, "a pickled view ships a descriptor, not bytes"
    ctx = mp.get_context("fork")
    q = ctx.Queue()
    p = ctx.Process(target=_child_read_view, args=(payload, q))
    p.start()
    p.join(10)
    results = dict(q.get(timeout=5) for _ in range(2))
    assert results.get("sum") == float(arr.sum())
    cons.commit()  # reclaim the slot: a late worker detects it
    p2 = ctx.Process(target=_child_read_reclaimed, args=(payload, q))
    p2.start()
    p2.join(10)
    kind, val = q.get(timeout=5)
    assert kind == "reclaimed", val


# -- engines on transport="shm" ----------------------------------------------------


def test_microbatch_engine_processes_shm_batches_zero_copy():
    cluster, _ = shm_cluster("mb")
    try:
        seen = {"n": 0, "sum": 0.0, "zero_copy_values": 0}

        def process(state, msgs):
            for m in msgs:
                seen["n"] += 1
                seen["sum"] += float(np.asarray(m.value).sum())
                seen["zero_copy_values"] += isinstance(m.value, ShmArrayView)
            return state

        stream = MicroBatchStream(cluster, "mb", group="g", process_fn=process,
                                  batch_interval=0.05, transport="shm")
        stream.start()
        prod = Producer(cluster, "mb")
        total = 0.0
        for i in range(8):
            vals = [np.full((16,), i * 10 + j, dtype=np.float64) for j in range(10)]
            total += float(sum(v.sum() for v in vals))
            prod.send_batch(vals)
        deadline = time.monotonic() + 15
        while seen["n"] < 80 and time.monotonic() < deadline:
            time.sleep(0.02)
        stream.stop()
        assert seen == {"n": 80, "sum": total, "zero_copy_values": 80}  # views, all of them
    finally:
        cluster.close()


# -- the detector source and the spec's transport fields ------------------------------


def test_detector_source_batches_through_the_ring():
    from repro_torch.miniapps import SOURCES, DetectorSimSource, SourceConfig

    assert SOURCES["detector"] is DetectorSimSource
    cluster, transport = shm_cluster("det", n_slots=32)
    src = DetectorSimSource(cluster, SourceConfig("det", total_messages=64),
                            ny=32, nx=32, n_cached=4, frames_per_batch=16)
    try:
        src.start()
        deadline = time.monotonic() + 10
        while not src.finished and time.monotonic() < deadline:
            time.sleep(0.02)
        assert src.finished and src.sent_records == 64
        assert cluster.topic("det").partitions[0].high_watermark == 64
        assert transport.ring_for("det").used_slots == 4  # 64/16 frames
        msgs = Consumer(cluster, ConsumerGroup(cluster, "g", "det"), "m0").poll(
            max_records=64, timeout=1.0)
        assert len(msgs) == 64
        assert msgs[0].value.dtype == np.uint16 and msgs[0].value.shape == (32, 32)
        assert np.array_equal(msgs[0].value, msgs[4].value)  # the cache replays
    finally:
        src.stop()
        cluster.close()


def test_detector_frames_equal_the_jax_package():
    """The same seed caches the same frames in both packages."""
    from repro.miniapps import DetectorSimSource as JaxDetector, SourceConfig as JaxConfig
    from repro_torch.miniapps import DetectorSimSource, SourceConfig

    for kw in ({}, {"ny": 24, "nx": 40, "dtype": "float32", "n_cached": 3}):
        ours = DetectorSimSource(BrokerCluster(1), SourceConfig("d", seed=5), **kw)
        theirs = JaxDetector(JaxCluster(1), JaxConfig("d", seed=5), **kw)
        assert len(ours._cache) == len(theirs._cache) and ours.frame_bytes == theirs.frame_bytes
        for a, b in zip(ours._cache, theirs._cache):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_detector_source_hdf5_input(tmp_path):
    import h5py

    from repro_torch.miniapps import DetectorSimSource, SourceConfig

    path = tmp_path / "frames.h5"
    frames = np.arange(3 * 8 * 8, dtype=np.uint16).reshape(3, 8, 8)
    with h5py.File(path, "w") as f:
        f.create_dataset("frames", data=frames)
    cluster, _ = shm_cluster("h5")
    src = DetectorSimSource(cluster, SourceConfig("h5", total_messages=3),
                            hdf5_path=str(path), n_cached=8, frames_per_batch=3)
    try:
        src.start()
        deadline = time.monotonic() + 10
        while not src.finished and time.monotonic() < deadline:
            time.sleep(0.02)
        msgs = Consumer(cluster, ConsumerGroup(cluster, "g", "h5"), "m0").poll(
            max_records=8, timeout=1.0)
        assert len(msgs) == 3
        for m, f in zip(msgs, frames):
            assert np.array_equal(m.value, f)
    finally:
        src.stop()
        cluster.close()


def test_pipeline_spec_roundtrips_transport_fields():
    from repro_torch.pipeline import Pipeline, PipelineSpec

    spec = (Pipeline.named("shm-pipe")
            .broker(nodes=1, transport="shm",
                    transport_options={"slot_bytes": 1 << 16, "n_slots": 8})
            .topic("frames", partitions=1)
            .source("frames", kind="detector", total_messages=10)
            .stage("agg", topic="frames", processor=lambda state, msgs: state,
                   transport="shm")
            .build())
    assert spec.broker.transport == "shm"
    assert spec.broker.transport_options == {"slot_bytes": 1 << 16, "n_slots": 8}
    assert spec.stage("agg").transport == "shm"
    assert PipelineSpec.from_dict(spec.to_dict()) == spec


def test_builder_rejects_bad_transport_combinations():
    from repro_torch.pipeline import Pipeline, PipelineValidationError

    with pytest.raises(PipelineValidationError) as exc:
        (Pipeline.named("bad")
         .broker(transport="carrier-pigeon")
         .topic("x", partitions=1)
         .stage("s", topic="x", processor=lambda st, ms: st, transport="shm")
         .build())
    assert "carrier-pigeon" in str(exc.value) and "requires the broker" in str(exc.value)


def test_a_detector_pipeline_runs_over_the_ring_and_leaves_no_segment():
    """A ``PipelineSpec`` on an shm broker: the detector source's frames
    reach an shm micro-batch stage as views, none copied out, and the run's
    teardown unlinks its ring."""
    from repro_torch.pipeline import Pipeline, register_processor

    seen = []

    @register_processor("shm_test_views")
    def views(state, msgs):
        seen.extend(isinstance(m.value, ShmArrayView) for m in msgs)
        return (state or 0) + len(msgs)

    spec = (Pipeline.named("det-shm")
            .broker(nodes=1, transport="shm", transport_options={"slot_bytes": 1 << 16,
                                                                 "n_slots": 8})
            .topic("frames", partitions=1)
            .source("frames", kind="detector", total_messages=48, ny=16, nx=16,
                    frames_per_batch=8, n_cached=4, rate_msgs_per_s=2000)
            .stage("agg", topic="frames", processor="shm_test_views", transport="shm",
                   batch_interval=0.02)
            .build())
    with spec.run(devices=[torch.device("cpu")]) as run:
        deadline = time.monotonic() + 20
        while not (run.sources_finished and run.stream("agg").stats.records == 48):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        ring = run.cluster.transport.ring_for("frames")
        name = ring.name
        assert ring.alloc_count == 6 and run.lag("agg") == 0
    assert run.errors == [] and len(seen) == 48 and all(seen)
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name)
