"""PyTorch port, the CUDA launchers' device: each ``*_cuda`` launcher enters
its tensors' device (so its kernel launches, and its outputs are allocated,
there whatever device is current) and passes that device's current stream;
it refuses tensors on several devices or off the card.  The kernels' opt-in
to more than 48 KB of shared memory (``csrc/opt_in.cuh``) is recorded per
device.

There is no card here: the tensors are fake CUDA tensors
(``FakeTensorMode``, no storage), ``torch.cuda.device`` and
``torch.cuda.current_stream`` are recorders, and each kernel library is a
stub that records the device that is current when it is called.  The opt-in
header is compiled with the host C++ compiler against a stub CUDA runtime."""

import contextlib
import subprocess
import types
import warnings
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from openvis_tpu_torch.ops import hungarian_cuda, msda_cuda, point_sample_cuda
from torch_port_common import one_thread_fixture

one_thread = one_thread_fixture()

CSRC = Path(__file__).resolve().parent.parent / "openvis_tpu_torch" / "csrc"
LEVELS = [(2, 3)]
NH, CH, P, LQ = 8, 32, 4, 5


class Devices:
    """Stands in for ``torch.cuda.device`` and ``torch.cuda.current_stream``:
    tracks the current device (cuda:0 at first) and gives each device's
    stream a handle of its own."""

    def __init__(self):
        self.current = torch.device("cuda:0")
        self.entered = []

    @contextlib.contextmanager
    def device(self, device):
        prev, self.current = self.current, torch.device(device)
        self.entered.append(self.current)
        try:
            yield
        finally:
            self.current = prev

    def current_stream(self, device=None):
        d = torch.device(device) if device is not None else self.current
        return types.SimpleNamespace(cuda_stream=1000 + d.index)


class Library:
    """A kernel library whose every entry point records the current device
    and its last argument (the stream) and returns 0 (success)."""

    def __init__(self, devices):
        self.devices, self.calls = devices, []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, self.devices.current, args[-1]))
            return 0
        return entry


def _hungarian(dev):
    return hungarian_cuda.batched_hungarian_cuda(torch.zeros(2, 4, 5, device=dev[0]))


def _msda_inputs(dev):
    value = torch.zeros(1, 6, NH, CH, device=dev[0])
    loc = torch.zeros(1, LQ, NH, 1, P, 2, device=dev[1])
    attn = torch.zeros(1, LQ, NH, 1, P, device=dev[-1])
    return value, loc, attn


def _k1(dev):
    value, loc, attn = _msda_inputs(dev)
    return msda_cuda.ms_deform_attn_cuda(value, LEVELS, loc, attn)


def _k2(dev):
    value, loc, attn = _msda_inputs(dev)
    return msda_cuda.msda_dcoord_cuda(value, LEVELS, loc, attn,
                                      torch.zeros(1, LQ, NH * CH, device=dev[-1]))


def _k3(dev):
    value, loc, attn = _msda_inputs(dev)
    return msda_cuda.msda_dvalue_cuda(value, LEVELS, loc, attn,
                                      torch.zeros(1, LQ, NH * CH, device=dev[-1]))


def _k5(dev):
    return point_sample_cuda.point_sample_fwd_cuda(torch.zeros(1, 2, 4, 5, device=dev[0]),
                                                   torch.zeros(1, 3, 2, device=dev[1]))


def _k6(dev):
    return point_sample_cuda.point_sample_dvalue_cuda(
        torch.zeros(1, 3, 2, device=dev[0]), torch.zeros(1, 2, 3, device=dev[1]),
        (1, 2, 4, 5), torch.float32)


LAUNCHERS = {  # name -> (call, the C entry point it launches through)
    "K1": (_k1, "msda_fwd"),
    "K2": (_k2, "msda_bwd_dcoord"),
    "K3": (_k3, "msda_bwd_dvalue"),
    "K4": (_hungarian, "hungarian_solve"),
    "K5": (_k5, "point_sample_fwd"),
    "K6": (_k6, "point_sample_dvalue"),
}


@pytest.fixture()
def fake_card(monkeypatch):
    devices = Devices()
    lib = Library(devices)
    monkeypatch.setattr(torch.cuda, "device", devices.device)
    monkeypatch.setattr(torch.cuda, "current_stream", devices.current_stream)
    for module, attr in ((msda_cuda, "library"), (msda_cuda, "bwd_library"),
                         (hungarian_cuda, "library"), (point_sample_cuda, "library")):
        monkeypatch.setattr(module, attr, lambda: lib)
    # the stub launches count; put the process-wide counters back afterwards
    for module, counter in ((msda_cuda, "launches"), (msda_cuda, "dcoord_launches"),
                            (msda_cuda, "dvalue_launches"), (hungarian_cuda, "launches"),
                            (point_sample_cuda, "fwd_launches"),
                            (point_sample_cuda, "dvalue_launches")):
        monkeypatch.setattr(module, counter, getattr(module, counter))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the fake tensors' data_ptr
        with FakeTensorMode(allow_non_fake_inputs=True):
            yield devices, lib


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_launcher_runs_on_its_tensors_device(fake_card, name):
    devices, lib = fake_card
    call, entry = LAUNCHERS[name]
    out = call(("cuda:1", "cuda:1"))
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o.device == torch.device("cuda:1") for o in outs)
    assert lib.calls == [(entry, torch.device("cuda:1"), 1001)]
    assert devices.entered == [torch.device("cuda:1")]
    assert devices.current == torch.device("cuda:0")  # left as it was


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_launcher_refuses_mixed_or_host_devices(fake_card, name):
    devices, lib = fake_card
    call = LAUNCHERS[name][0]
    cases = [("cpu", "cpu")] if name == "K4" else [("cuda:0", "cuda:1"), ("cuda:1", "cpu")]
    for dev in cases:
        with pytest.raises(ValueError, match="one CUDA device"):
            call(dev)
    assert lib.calls == [] and devices.entered == []


STUB_RUNTIME = """
#pragma once
#include <vector>
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidDevice = 101 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
extern int current_device;
extern std::vector<int> set_on;   // the device of each cudaFuncSetAttribute
inline cudaError_t cudaGetDevice(int* d) { *d = current_device; return cudaSuccess; }
template <typename T>
cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) {
  set_on.push_back(current_device);
  return cudaSuccess;
}
"""

STUB_MAIN = """
#include <cstdio>
#include "opt_in.cuh"
int current_device = 0;
std::vector<int> set_on;
void kernel_a() {}
void kernel_b() {}
int main() {
  static bool a[kMaxOptInDevices] = {};
  static bool b[kMaxOptInDevices] = {};
  for (int d : {0, 0, 1, 1, 0, 3}) {   // devices made current in turn
    current_device = d;
    if (opt_in_shared_memory(kernel_a, 1 << 17, a) != cudaSuccess) return 1;
  }
  current_device = 1;
  if (opt_in_shared_memory(kernel_b, 1 << 17, b) != cudaSuccess) return 1;
  current_device = kMaxOptInDevices;
  if (opt_in_shared_memory(kernel_a, 1 << 17, a) != cudaErrorInvalidDevice) return 1;
  for (int d : set_on) std::printf("%d ", d);
  return 0;
}
"""


def test_shared_memory_opt_in_is_per_device(tmp_path):
    """Each kernel opts in once on each device it is launched on (0, 1, 3
    for one kernel, 1 for another), and a device beyond the table fails."""
    (tmp_path / "cuda_runtime.h").write_text(STUB_RUNTIME)
    (tmp_path / "main.cc").write_text(STUB_MAIN)
    exe = tmp_path / "opt_in"
    subprocess.run(["c++", "-std=c++17", "-I", str(tmp_path), "-I", str(CSRC),
                    "-o", str(exe), str(tmp_path / "main.cc")], check=True, timeout=120)
    out = subprocess.run([str(exe)], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0
    assert out.stdout.split() == ["0", "1", "3", "1"]


@pytest.mark.parametrize("source", ["hungarian.cu", "msda_bwd.cu", "point_sample.cu"])
def test_sources_opt_in_through_the_per_device_table(source):
    """Every opt-in of the kernels goes through ``opt_in_shared_memory`` with
    a per-device flag table, none through a process-wide flag."""
    text = (CSRC / source).read_text()
    assert "cudaFuncSetAttribute" not in text
    assert "opt_in_shared_memory(" in text
    assert text.count("[kMaxOptInDevices] = {};") == text.count("opt_in_shared_memory(")
    assert "static bool opted = false" not in text and "static bool opted_in = false" not in text
    assert '#include "opt_in.cuh"' in text
