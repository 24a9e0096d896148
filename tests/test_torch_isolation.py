"""The port stands alone and never lands on the CPU by accident:

* no module of ``src/repro_torch`` (nor ``chip_smoke.py`` or ``tools/``)
  imports ``jax`` or the JAX package ``repro``;
* the device pool and the apps refuse to start without CUDA unless a CPU
  device is named;
* a CUDA tensor never reaches a plain version: the wrappers branch on the
  tensor's device, and the kernel launchers refuse anything but CUDA.
"""
import ast
from pathlib import Path

import pytest
import torch

import repro_torch.core as core
from repro_torch.broker import BrokerCluster, Consumer, ConsumerGroup, Producer
from repro_torch.engines.microbatch import MicroBatchStream
from repro_torch.configs import get_arch
from repro_torch.kernels import KERNELS, _build
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.kmeans import ops as kmeans_ops
from repro_torch.kernels.tomo import ops as tomo_ops
from repro_torch.launch import serve
from repro_torch.miniapps import LMServeApp, ReconstructionApp, StreamingKMeans, state_from_jax
from repro_torch.models import build_model, params_from_jax
from repro_torch.serving import ContinuousBatcher, PagedKVCache

# the suite runs in parallel worker processes; these tensors are tiny, so one
# intra-op thread keeps torch from oversubscribing the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*.py")))


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_wrappers_have_no_fallback_paths():
    """No ``try`` in the wrapper modules: a CUDA launch that fails raises,
    it is never retried on the plain version."""
    for mod in (kmeans_ops, tomo_ops, attn_ops):
        tree = ast.parse(Path(mod.__file__).read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], mod.__name__


def test_every_kernel_has_a_source_and_entry_point():
    assert [k.name for k in KERNELS] == ["kmeans_assign", "kmeans_update", "tomo_backproject",
                                         "tomo_project", "flash_attention", "decode_attention"]
    for k in KERNELS:
        src = k.source.read_text()
        assert k.source.parent == _build.CSRC
        assert f"int {k.entry}(" in src and "cudaGetLastError()" in src
        assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def test_device_pool_needs_cuda_or_named_devices(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        core.DevicePool()
    with pytest.raises(RuntimeError, match="CUDA"):
        core.PilotComputeService()
    pool = core.DevicePool(devices=[torch.device("cpu")])
    assert pool.total_devices == 1


def test_apps_need_cuda_or_a_cpu_device(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingKMeans()
    with pytest.raises(RuntimeError, match="CUDA"):
        ReconstructionApp("gridrec")
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_jax({"centroids": [[0.0, 0.0]]}, "cuda")
    assert StreamingKMeans(device="cpu").centroids.device.type == "cpu"
    assert ReconstructionApp("mlem", device="cpu").device.type == "cpu"


def test_serving_path_needs_cuda_or_a_cpu_device(no_cuda):
    cfg = get_arch("smollm-135m").reduced()
    model = build_model(cfg)
    for mode in ("lockstep", "continuous"):
        with pytest.raises(RuntimeError, match="CUDA"):
            LMServeApp(cfg, mode=mode)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatcher(model, n_pages=4, page_size=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache.from_model(model, n_pages=4, page_size=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"embed": [[0.0]]}, "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced", "--requests", "1"])
    assert LMServeApp(cfg, mode="continuous", n_pages=4, page_size=4,
                      device="cpu")._batcher.cache.k.device.type == "cpu"


class _FakeCuda:
    """Stands in for a CUDA tensor (there is no card here): the wrappers
    only look at ``.device``, and make it contiguous and cast it, before
    they hand it on."""

    device = torch.device("cuda", 0)

    def to(self, *args, **kwargs):
        return self

    def contiguous(self):
        return self


def test_cuda_tensor_goes_to_the_kernel_not_the_plain_version(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    calls = []
    monkeypatch.setattr(kmeans_ops, "assign_ref", plain)
    monkeypatch.setattr(kmeans_ops, "assign_cuda", lambda *a: calls.append("assign") or "k")
    monkeypatch.setattr(kmeans_ops, "update_scatter_ref", plain)
    monkeypatch.setattr(kmeans_ops, "update_cuda", lambda *a: calls.append("update") or "k")
    monkeypatch.setattr(tomo_ops, "trig", lambda angles: (angles, angles))
    monkeypatch.setattr(tomo_ops, "backproject_plain", plain)
    monkeypatch.setattr(tomo_ops, "project_plain", plain)
    monkeypatch.setattr(tomo_ops, "backproject_cuda", lambda *a: calls.append("bp") or "k")
    monkeypatch.setattr(tomo_ops, "project_cuda", lambda *a: calls.append("fp") or "k")
    monkeypatch.setattr(attn_ops, "flash_attention_plain", plain)
    monkeypatch.setattr(attn_ops, "decode_attention_plain", plain)
    monkeypatch.setattr(attn_ops, "flash_attention_cuda", lambda *a, **k: calls.append("fa") or "k")
    monkeypatch.setattr(attn_ops, "decode_attention_cuda", lambda *a: calls.append("da") or "k")
    x = _FakeCuda()
    assert kmeans_ops.assign(x, x) == "k"
    assert kmeans_ops.update_scatter(x, x, 3) == "k"
    assert tomo_ops.backproject_batch(x, x, 8) == "k"
    assert tomo_ops.project_batch(x, x, 8) == "k"
    assert attn_ops.flash_attention(x, x, x) == "k"
    assert attn_ops.decode_attention(x, x, x, x) == "k"
    assert calls == ["assign", "update", "bp", "fp", "fa", "da"]


def test_kernel_launchers_refuse_non_cuda_tensors():
    pts, cen = torch.zeros(4, 3), torch.zeros(2, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kmeans_ops.assign_cuda(pts, cen)
    with pytest.raises(ValueError, match="CUDA"):
        kmeans_ops.update_cuda(pts, torch.zeros(4, dtype=torch.int32), 2)
    cos_t = sin_t = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        tomo_ops.backproject_cuda(torch.zeros(1, 4, 6), cos_t, sin_t, 5)
    with pytest.raises(ValueError, match="CUDA"):
        tomo_ops.project_cuda(torch.zeros(1, 5, 5), cos_t, sin_t, 6)
    q, kv = torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        attn_ops.flash_attention_cuda(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        attn_ops.decode_attention_cuda(q[:, :1], kv, kv, torch.zeros(1, dtype=torch.int32))
    assert all(k.launches == 0 for k in KERNELS)


def test_attention_wrappers_refuse_cpu_and_cuda_mixed():
    """A CPU tensor beside a CUDA one is refused before anything runs."""
    q = torch.zeros(1, 4, 2, 32)
    x = _FakeCuda()
    with pytest.raises(ValueError, match="one device"):
        attn_ops.flash_attention(q, x, x)
    with pytest.raises(ValueError, match="one device"):
        attn_ops.decode_attention(x, x, x, torch.zeros(1, dtype=torch.int32))


def test_build_needs_nvcc(monkeypatch):
    import torch.utils.cpp_extension as ext

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


def test_shared_memory_transport_is_refused():
    cluster = BrokerCluster(1)
    cluster.create_topic("t", 1)
    with pytest.raises(NotImplementedError, match="transport"):
        cluster.attach_transport(object())
    with pytest.raises(NotImplementedError, match="transport"):
        MicroBatchStream(cluster, "t", group="g", process_fn=lambda s, m: s, transport="shm")
    Producer(cluster, "t", serializer="raw").send(b"S" + b"\x00" * 8)
    consumer = Consumer(cluster, ConsumerGroup(cluster, "g", "t"), "m")
    with pytest.raises(NotImplementedError, match="transport"):
        consumer.poll(timeout=0.5)
