"""The port's resource arbiter against the JAX package's, on the same
requests: weighted fair share, gang allocation, the grants, revocations and
preemptions of a reconcile sequence over real pool leases, co-location
groups, online packing and placement. Plain Python in both packages, so
the results must be equal."""
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.scheduler as jax_sched
import repro_torch.core as torch_core
import repro_torch.scheduler as torch_sched
from repro_torch.elastic import MetricsBus

torch.set_num_threads(1)

PACKAGES = {"jax": (jax_core, jax_sched), "torch": (torch_core, torch_sched)}


def _devices(pkg: str, n: int) -> list:
    return list(range(n)) if pkg == "jax" else [torch.device("cpu")] * n


def _random_requests(sched, rng, n):
    reqs = []
    for i in range(n):
        lo = int(rng.integers(0, 3))
        hi = lo + int(rng.integers(0, 6))
        r = sched.ResourceRequest(f"r{i}", min_devices=lo, max_devices=hi,
                                  weight=float(rng.choice([0.5, 1.0, 2.0, 3.0])),
                                  priority=int(rng.integers(0, 3)),
                                  colocate_with=(f"r{int(rng.integers(0, n))}"
                                                 if rng.random() < 0.3 else None))
        r.set_target(int(rng.integers(0, 9)))
        reqs.append(r)
    return reqs


@pytest.mark.parametrize("seed", range(8))
def test_allocation_matches_jax(seed):
    """Weighted fair share, colocation groups (cycles tolerated) and the
    demand clamp on the same random request books."""
    out = []
    for _, sched in PACKAGES.values():
        rng = np.random.default_rng(seed)
        reqs = _random_requests(sched, rng, 7)
        groups = {k: sorted(r.name for r in v) for k, v in sched.colocation_groups(reqs).items()}
        out.append((sched.weighted_fair_share(reqs, int(rng.integers(4, 20))), groups,
                    [r.demand for r in reqs]))
    assert out[0] == out[1]


def test_requests_refuse_the_same_bad_bands():
    for bad in (dict(weight=0), dict(min_devices=-1), dict(min_devices=3, max_devices=2)):
        msgs = []
        for _, sched in PACKAGES.values():
            with pytest.raises(ValueError) as ei:
                sched.ResourceRequest("x", **bad)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


# (tick, action, *args): submit a tenant request, revise a demand, withdraw
SCRIPT = [
    (0, "submit", "lo", dict(min_devices=1, priority=0)), (0, "update", "lo", 6),
    (1, "submit", "mid", dict(min_devices=0, priority=0, weight=2.0)), (1, "update", "mid", 6),
    (2, "submit", "hi", dict(min_devices=0, priority=1)), (2, "update", "hi", 3),
    (3, "reserve", "fixed", dict(min_devices=1, max_devices=1)),
    (4, "update", "hi", 0),
    (5, "submit", "g1", dict(min_devices=1, colocate_with="g0")),
    (5, "submit", "g0", dict(min_devices=0)), (5, "update", "g0", 4), (5, "update", "g1", 4),
    (6, "withdraw", "mid"), (7, "update", "lo", 2),
]


def _drive_arbiter(pkg: str) -> tuple:
    core, sched = PACKAGES[pkg]
    svc = core.PilotComputeService(devices=_devices(pkg, 10))
    try:
        arb = svc.get_arbiter()
        tenants = {}
        ticks = []
        for tick in range(9):
            for t, action, name, *args in SCRIPT:
                if t != tick:
                    continue
                if action == "submit":
                    tenants[name] = sched.PoolTenant(svc)
                    arb.submit(tenants[name].request(name, **args[0]))
                elif action == "reserve":
                    arb.submit(sched.ResourceRequest(name, **args[0]))
                elif action == "update":
                    arb.update(name, args[0])
                else:
                    arb.withdraw(name)
                    tenants.pop(name).close()
            granted = arb.reconcile()
            ticks.append((sorted(granted.items()),
                          sorted((n, t.devices) for n, t in tenants.items()),
                          svc.pool.free_devices))
        placement = arb.placement(bin_size=4)
        events = [(e.action, e.delta, e.devices_before, e.devices_after, e.reason)
                  for e in arb.events]
        gauges = [(s.name, s.value, s.labels) for s in arb.bus.history()
                  if s.name.startswith("scheduler.")]
        result = (ticks, events, placement, arb.preemptions, gauges)
        for t in tenants.values():
            t.close()
        return result
    finally:
        svc.cancel()


def test_reconcile_sequence_matches_jax():
    """Grants, revocations, preemptions (strict priority), a static
    reservation, a gang that only fits whole, a withdrawal: the same grants
    after every pass, the same events, placement and ``scheduler.*``
    gauges, and the pool never oversubscribed."""
    jax_run, torch_run = _drive_arbiter("jax"), _drive_arbiter("torch")
    assert torch_run == jax_run
    ticks, events, _, preemptions, gauges = torch_run
    assert preemptions >= 1 and {"grant", "revoke", "preempt"} <= {e[0] for e in events}
    assert all(free >= 0 for *_, free in ticks)
    assert all(v >= 0 for name, v, _ in gauges if name == "scheduler.free")


def test_gang_allocation_and_rollback_match_jax():
    """A co-located pair that contention would split is withheld whole; a
    member whose actuator fails rolls the gang back."""
    out = []
    for pkg, (core, sched) in PACKAGES.items():
        svc = core.PilotComputeService(devices=_devices(pkg, 5))
        try:
            arb = sched.ResourceArbiter(svc)
            big = sched.PoolTenant(svc)
            arb.submit(big.request("big", min_devices=2, priority=1))
            arb.update("big", 4)
            a, b = sched.PoolTenant(svc), sched.PoolTenant(svc)
            arb.submit(a.request("a", min_devices=0))
            rb = b.request("b", min_devices=0, colocate_with="a")
            arb.submit(rb)
            arb.update("a", 1)
            arb.update("b", 2)
            first = (arb.allocate(), arb.reconcile())
            arb.update("big", 2)
            rb.actuator = lambda n: (_ for _ in ()).throw(RuntimeError("no"))
            second = arb.reconcile()
            out.append((first, second, a.devices, b.devices,
                        [(e.action, e.delta) for e in arb.events]))
            for t in (big, a, b):
                t.close()
        finally:
            svc.cancel()
    assert out[0] == out[1]
    assert "gang_rollback" in {e for e, _ in out[1][4]}


def test_online_packer_matches_jax():
    rng = np.random.default_rng(11)
    packers = [sched.OnlinePacker(8) for _, sched in PACKAGES.values()]
    for step in range(40):
        demands = {f"g{i}": float(rng.integers(0, 6)) for i in range(int(rng.integers(1, 9)))}
        bins = [p.repack(demands) for p in packers]
        assert bins[0] == bins[1]
        assert [p.bin_of("g0") for p in packers][0] == packers[1].bin_of("g0")
        if step == 20:
            for p in packers:
                p.reset(6)
    assert packers[0].relocations == packers[1].relocations


def test_service_has_one_arbiter_and_cancel_stops_it():
    svc = torch_core.PilotComputeService(devices=[torch.device("cpu")] * 2)
    bus = MetricsBus()
    arb = svc.get_arbiter(bus)
    assert svc.get_arbiter() is arb and arb.bus is bus
    with pytest.warns(UserWarning, match="different"):
        assert svc.get_arbiter(MetricsBus()) is arb
    arb.retain()
    assert arb._thread is not None and arb._thread.is_alive()
    svc.cancel()
    assert arb._thread is None


def test_serving_launcher_registers_its_stream_with_the_arbiter(monkeypatch):
    """``launch/serve.py`` files a fixed request for the devices its stream
    holds, as the JAX launcher does."""
    from repro_torch.launch import serve

    seen = []
    real = torch_core.PilotComputeService.get_arbiter

    def spy(self, bus=None, **kw):
        arb = real(self, bus, **kw)
        seen.append(arb)
        return arb

    monkeypatch.setattr(torch_core.PilotComputeService, "get_arbiter", spy)
    serve.main(["--reduced", "--device", "cpu", "--requests", "1", "--gen-tokens", "2",
                "--prompt-len", "8", "--batch", "1"])
    (arb,) = seen
    (req,) = arb.requests
    assert req.name == "launch/serve"
    assert (req.min_devices, req.max_devices, req.target) == (1, 1, 1)
