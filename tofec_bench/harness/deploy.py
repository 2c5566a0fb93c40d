"""The proxy deployment every configuration shares: the emulated store, the
shared-key layout, the K1 codec and the TOFEC proxy, built from the
configuration's ``deployment`` block, and the objects set-up stores."""

from __future__ import annotations

import threading
import time

import torch

from repro_torch.coding.codec import Codec
from repro_torch.coding.layout import layout_for_file
from repro_torch.core import RequestClass, TOFECPolicy
from repro_torch.core.delay_model import DelayParams
from repro_torch.storage.proxy import Proxy

from tofec_bench.harness import store as store_mod
from tofec_bench.harness import traffic
from tofec_bench.harness.tofec_ref import Recorder, TofecReference, clamp


class Deployment:
    """``deployment`` keys: ``file_bytes``, ``L``, ``k_max``, ``r_max``,
    ``alpha``, ``read_delay`` (a name in ``store.DELAYS``),
    ``time_scale``."""

    def __init__(self, dep: dict, seed: int, device):
        self.dep = dep
        self.file_bytes = int(dep["file_bytes"])
        self.L = int(dep["L"])
        self.k_max, self.r_max = int(dep["k_max"]), int(dep["r_max"])
        self.read_delay = store_mod.DELAYS[dep["read_delay"]]
        self.store = store_mod.EmulatedS3(self.read_delay, seed_rng=traffic.rng(seed, "store"),
                                          time_scale=float(dep["time_scale"]))
        self.layout = layout_for_file(self.file_bytes, self.k_max, self.r_max)
        self.codec = Codec("kernel", device=device)
        d = self.read_delay
        self.request_class = RequestClass(
            "read", self.file_bytes / 2**20,
            DelayParams(d.delta_bar, d.delta_tilde, d.psi_bar, d.psi_tilde),
            k_max=self.k_max, r_max=float(self.r_max), n_max=self.k_max * self.r_max)
        self.policy = Recorder(TOFECPolicy.for_classes([self.request_class], self.L,
                                                       alpha=float(dep["alpha"])))
        self.proxy = Proxy(self.store, self.policy, L=self.L, codec=self.codec)
        #: K1 calls (wall-clock ns, bit-matrix shape, data shape) while recording
        self.k1_calls: list[tuple[float, tuple, tuple]] = []
        self._k1_seen = 0
        self._recording = False
        self._wrapped = False
        self._lock = threading.Lock()
        if self.codec.device.type != "cuda":
            self._wrap_k1()

    def k1_count(self) -> int:
        """K1's launch counter on the card; on the CPU, where K1's plain
        version runs in its place and launches nothing, the codec's calls
        into it."""
        if self.codec.device.type == "cuda":
            from repro_torch.kernels.gf2mm.gf2mm import gf2_rs_matmul_bytes

            return gf2_rs_matmul_bytes.launches
        return self._k1_seen

    def _wrap_k1(self) -> None:
        """Watch the codec's calls into its kernel, at the boundary between
        the two: count them, and keep their shapes while recording."""
        if self._wrapped:
            return
        backend = self.codec.backend
        inner = backend.matmul_prepped

        def watched(bitmats, data):
            with self._lock:
                self._k1_seen += 1
                if self._recording:
                    self.k1_calls.append((time.time_ns(), tuple(bitmats.shape),
                                          tuple(data.shape)))
            return inner(bitmats, data)

        backend.matmul_prepped = watched
        self._wrapped = True

    def record_k1(self) -> None:
        """Keep the shapes of every codec call into K1 from now on."""
        self._wrap_k1()
        self._recording = True

    def stop_k1(self) -> None:
        self._recording = False

    def store_objects(self, keys: list[str], payloads: list[bytes], batch: int = 32) -> None:
        """Encode the payloads through the program's codec (K1), a batch at a
        time, and put each coded object in the store, delay off."""
        for i in range(0, len(keys), batch):
            coded = self.layout.encode_files(payloads[i:i + batch], codec=self.codec)
            for key, blob in zip(keys[i:i + batch], coded):
                self.store.put(key, blob)

    def reference_codes(self) -> list[tuple[int, int]]:
        """The code the proxy should have used for each ``select`` so far."""
        ref = TofecReference(self.read_delay, self.file_bytes / 2**20, k_max=self.k_max,
                             r_max=float(self.r_max), n_max=self.k_max * self.r_max, L=self.L,
                             alpha=float(self.dep["alpha"]))
        picks = ref.picks([q for q, _ in self.policy.calls])
        return [clamp(p, self.layout.K, self.layout.N) for p in picks]

    def close(self) -> None:
        self.proxy.close()


def random_bytes(seed: int, count: int, nbytes: int, device) -> list[bytes]:
    """``count`` payloads of ``nbytes`` random bytes each, drawn on the device
    from the run's seed."""
    gen = torch.Generator(device=device).manual_seed(traffic.stream_seed(seed, "payloads"))
    out = torch.randint(0, 256, (count, nbytes), dtype=torch.uint8, device=device, generator=gen)
    host = out.cpu().numpy()
    return [host[i].tobytes() for i in range(count)]


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    import os

    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def wait_until(t: float) -> None:
    d = t - time.monotonic()
    if d > 0:
        time.sleep(d)


def key_name(i: int) -> str:
    return f"obj/{i:05d}"


def release(device) -> None:
    """Free what a finished run left on the device, and restart the peak
    memory count."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
