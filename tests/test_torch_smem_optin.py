"""The shared-memory opt-in of the port's kernels (`csrc/smem.cuh`
`SmemOptIn`), on the CPU.

`cudaFuncSetAttribute(..., MaxDynamicSharedMemorySize, ...)` holds only for
the card that is current when it is called, so each launcher must set it
again on every card it launches on. Here the header is compiled by the host
C++ compiler against a stand-in for the CUDA runtime (a current card per
thread, a log of the attributes set, an error to return on demand), and a
program drives two launchers the way the kernels' libraries do:

  (a) nothing is set up to the 48 KB default; past it, the attribute is set
      on the first launch on each card, once per card and launcher: a
      launcher that launched on card 0 first sets it again on card 1;
  (b) a refused attribute is returned, on that card, at every launch after
      it, and set no second time; a card index past MAX_CARDS is refused;
  (c) threads, one per card and eight on one card, each get the attribute
      set on their card before their first launch returns;
  (d) every launcher in csrc/ that opts in does so through a static
      SmemOptIn of its own, at each of its opt-in calls.
"""
import re
import subprocess
import tempfile
from pathlib import Path

import pytest

from rustpotter_tpu_torch import _build

STUB = r"""
#pragma once
#include <mutex>
#include <vector>
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct SetCall { int card; const void* kernel; int bytes; };
inline thread_local int g_card = 0;
inline std::mutex g_mu;
inline std::vector<SetCall> g_calls;
inline cudaError_t g_refuse = cudaSuccess;
inline cudaError_t cudaGetDevice(int* card) { *card = g_card; return cudaSuccess; }
template <class T>
cudaError_t cudaFuncSetAttribute(T* entry, cudaFuncAttribute attr, int value) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (attr == cudaFuncAttributeMaxDynamicSharedMemorySize)
    g_calls.push_back({g_card, reinterpret_cast<const void*>(entry), value});
  return g_refuse;
}
"""

PROGRAM = r"""
#include <cstdio>
#include <thread>
#include <vector>
#include "smem.cuh"

void kernel_a(int) {}
void kernel_b(int) {}
int launch_a(int bytes) { static SmemOptIn opt_in; return opt_in(kernel_a, bytes); }
int launch_b(int bytes) { static SmemOptIn opt_in; return opt_in(kernel_b, bytes); }

// "<step> <returned> <attributes set so far>" after each launch, then the log
void step(const char* name, int card, int (*launch)(int), int bytes) {
  g_card = card;
  const int ret = launch(bytes);
  std::printf("step %s %d %zu\n", name, ret, g_calls.size());
}

int main() {
  step("a0_default", 0, launch_a, 48 * 1024);
  step("a0", 0, launch_a, 60000);
  step("a0_again", 0, launch_a, 60000);
  step("a1", 1, launch_a, 60000);
  step("b1", 1, launch_b, 70000);
  step("b0", 0, launch_b, 70000);
  step("a1_again", 1, launch_a, 60000);
  g_refuse = cudaErrorInvalidValue;
  step("a2_refused", 2, launch_a, 60000);
  g_refuse = cudaSuccess;
  step("a2_again", 2, launch_a, 60000);
  step("a64", MAX_CARDS, launch_a, 60000);
  step("a_minus1", -1, launch_a, 60000);
  const size_t before = g_calls.size();
  std::vector<int> rets(16, -1);
  std::vector<std::thread> threads;
  for (int i = 0; i < 16; ++i)
    threads.emplace_back([i, &rets] {
      g_card = i < 8 ? 3 + i : 11;  // one thread on each of cards 3-10, eight on 11
      int r = 0;
      for (int k = 0; k < 100; ++k) r |= launch_b(70000);
      // the attribute stands on this card before the launches returned
      std::lock_guard<std::mutex> lock(g_mu);
      bool set = false;
      for (const SetCall& c : g_calls) set |= c.card == g_card;
      rets[i] = set ? r : -2;
    });
  for (std::thread& t : threads) t.join();
  for (int i = 0; i < 16; ++i) std::printf("thread %d %d\n", i, rets[i]);
  for (size_t i = before; i < g_calls.size(); ++i)
    std::printf("threadset %d\n", g_calls[i].card);
  for (size_t i = 0; i < before; ++i)
    std::printf("set %d %s %d\n", g_calls[i].card,
                g_calls[i].kernel == reinterpret_cast<const void*>(kernel_a) ? "a" : "b",
                g_calls[i].bytes);
  return 0;
}
"""


@pytest.fixture(scope="module")
def run():
    """The program's output: {step: (returned, attributes set so far)},
    [(card, kernel, bytes) set before the threads], {thread: returned},
    [card of each attribute the threads set]."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "cuda_runtime.h").write_text(STUB)
        (tmp / "main.cpp").write_text(PROGRAM)
        exe = tmp / "optin"
        subprocess.run([_build.cxx(), "-std=c++17", "-O1", "-pthread", f"-I{tmp}",
                        f"-I{_build.CSRC}", "-o", str(exe), str(tmp / "main.cpp")], check=True)
        out = subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout
    steps, sets, threads, thread_sets = {}, [], {}, []
    for line in out.splitlines():
        kind, *f = line.split()
        if kind == "step":
            steps[f[0]] = (int(f[1]), int(f[2]))
        elif kind == "set":
            sets.append((int(f[0]), f[1], int(f[2])))
        elif kind == "thread":
            threads[int(f[0])] = int(f[1])
        else:
            thread_sets.append(int(f[0]))
    return steps, sets, threads, thread_sets


def test_the_default_48_kb_needs_no_attribute(run):
    steps = run[0]
    assert steps["a0_default"] == (0, 0)


def test_the_attribute_is_set_once_on_each_card(run):
    steps, sets = run[0], run[1]
    assert steps["a0"] == (0, 1) and steps["a0_again"] == (0, 1)
    # launched on card 0 first, the launcher sets it again on card 1
    assert steps["a1"] == (0, 2) and steps["a1_again"] == (0, 4)
    assert steps["b1"] == (0, 3) and steps["b0"] == (0, 4)
    assert sets[:4] == [(0, "a", 60000), (1, "a", 60000), (1, "b", 70000), (0, "b", 70000)]


def test_a_refused_attribute_is_returned_at_every_launch_on_its_card(run):
    steps, sets = run[0], run[1]
    assert steps["a2_refused"] == (1, 5) and steps["a2_again"] == (1, 5)
    assert sets[4] == (2, "a", 60000) and len(sets) == 5


@pytest.mark.parametrize("which", ["a64", "a_minus1"])
def test_a_card_past_the_table_is_refused(run, which):
    assert run[0][which] == (101, 5)  # cudaErrorInvalidDevice, nothing set


def test_threads_get_the_attribute_on_their_card(run):
    threads, thread_sets = run[2], run[3]
    assert threads == {i: 0 for i in range(16)}
    assert sorted(set(thread_sets)) == list(range(3, 12))
    # one thread per card sets it once; eight on one card may race to set it
    assert all(thread_sets.count(c) == 1 for c in range(3, 11))
    assert 1 <= thread_sets.count(11) <= 8


# the launch sites with an opt-in of their own, per source: K4's ring and
# column forms each have one, as BQ's three forms do
LAUNCHERS = {"fused_dtw_v4.cu": 1, "fused_dtw_v3.cu": 1, "fused_dtw_v2.cu": 2,
             "fused_dtw_v1.cu": 1, "banded_dtw.cu": 1, "biquad.cu": 3}


@pytest.mark.parametrize("source", sorted(LAUNCHERS))
def test_each_launcher_keeps_its_own_per_card_opt_in(source):
    text = (_build.CSRC / source).read_text()
    assert '#include "smem.cuh"' in text
    calls = re.findall(r"^( *)static SmemOptIn opt_in;\n\1const cudaError_t attr = "
                       r"opt_in\((\w+(?:<[^>]*>)?), (\w+)\);$", text, re.M)
    assert len(calls) == LAUNCHERS[source], calls
    assert len(re.findall(r"\bopt_in\(", text)) == LAUNCHERS[source]
    assert "static const cudaError_t" not in text
