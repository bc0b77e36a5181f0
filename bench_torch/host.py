"""The host around a bench run: what the process may run on, and what
else used the machine while a cell was timed.

The text cells are bound by host work, so their end-to-end numbers move
with the host.  Per request (per round in ``session-mix``) the bench
reads the process's CPU time, the kernel's share of it, and its
involuntary context switches (``getrusage``: every thread's, the pack
threads' among them); over a cell's timed window it reads the machine's
CPU time from ``/proc/stat``: the share the hypervisor stole and the
CPUs' worth that other processes used.  These read only ``/proc`` and
``/sys``, never the checkout; where they do not exist, or where
``/proc/stat`` counts less work than this process did alone (a sandbox
that makes the file up), a reading is None ("not measured").
"""

from __future__ import annotations

import glob
import os
import resource
import time

#: /proc/stat's cpu fields that are work (idle, iowait and steal are not;
#: guest time is inside user already).
_BUSY = ("user", "nice", "system", "irq", "softirq")
_FIELDS = ("user", "nice", "system", "idle", "iowait", "irq", "softirq",
           "steal")


def _text(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def machine() -> dict:
    """CPUs the process may run on, CPUs online, NUMA nodes, the CPU
    model, and whether the kernel runs under a hypervisor."""
    cpuinfo = _text("/proc/cpuinfo") or ""
    model = next((ln.split(":", 1)[1].strip() for ln in cpuinfo.splitlines()
                  if ln.startswith("model name")), None)
    nodes = glob.glob("/sys/devices/system/node/node[0-9]*")
    return {
        "affinity_cpus": len(os.sched_getaffinity(0)),
        "online_cpus": os.cpu_count(),
        "numa_nodes": len(nodes) or None,
        "cpu_model": model,
        "hypervisor": (" hypervisor" in cpuinfo) if cpuinfo else None,
    }


def _stat() -> dict | None:
    text = _text("/proc/stat")
    if not text:
        return None
    cols = text.splitlines()[0].split()[1:1 + len(_FIELDS)]
    return dict(zip(_FIELDS, (int(c) for c in cols)))


def process() -> tuple:
    """(user CPU seconds, kernel CPU seconds, involuntary context
    switches) of the process so far."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime, ru.ru_stime, ru.ru_nivcsw


class Window:
    """The machine's CPU time over a timed window: open it with
    :meth:`start`, close it with :meth:`stop`, then read
    :attr:`steal_share` and :attr:`others_cpus`."""

    steal_share: float | None = None
    others_cpus: float | None = None

    def start(self) -> None:
        self._t = time.perf_counter()
        self._cpu = time.process_time()
        self._stat = _stat()

    def stop(self) -> None:
        wall = time.perf_counter() - self._t
        ours = time.process_time() - self._cpu
        end = _stat()
        if self._stat is None or end is None or wall <= 0:
            return
        d = {k: end[k] - self._stat[k] for k in _FIELDS}
        total = sum(d.values())
        busy = sum(d[k] for k in _BUSY) / os.sysconf("SC_CLK_TCK")
        if total <= 0 or busy < 0.9 * ours:    # not this machine's count
            return
        self.steal_share = d["steal"] / total
        self.others_cpus = (busy - ours) / wall
