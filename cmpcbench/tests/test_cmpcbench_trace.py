"""The reduction of raw profiler events: each device operation placed in
the host range that launched it, the busy union and the idle gaps."""
import types

from cmpcbench import trace

CPU, CUDA = types.SimpleNamespace(name="CPU"), types.SimpleNamespace(name="CUDA")


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, linked=0):
        self._v = (name, dev, start, dur, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


HOST = [("run_batched", 300, 500), ("draw", 100, 250), ("wait", 600, 1600)]  # not in time order


def _events():
    return [
        # the runtime calls that launched each device operation, on the host
        Ev("cudaLaunchKernel", CPU, 130, 5, corr=6),
        Ev("cudaLaunchKernel", CPU, 330, 5, corr=7),
        Ev("cudaMemsetAsync", CPU, 450, 20, corr=8),
        Ev("cudaLaunchKernel", CPU, 520, 5, corr=9),  # between two ranges
        Ev("distribution_kernel", CUDA, 200, 100, corr=6),
        Ev("remainder_kernel", CUDA, 400, 300, corr=7),
        Ev("Memset (Device)", CUDA, 800, 100, corr=8),
        Ev("index_kernel", CUDA, 950, 20, corr=9),
        # a launch whose runtime call the profile did not record
        Ev("gfmm::lonely", CUDA, 1000, 100, corr=12345),
    ]


def test_device_operations_take_the_host_range_that_launched_them():
    tr = trace.reduce_events(_events(), HOST, (50, 2050))
    assert tr["window_ns"] == (50, 2050)
    assert [h[0] for h in tr["host"]] == ["draw", "run_batched", "wait"]
    labels = {d[0]: d[3] for d in tr["device"]}
    assert labels == {"distribution_kernel": "draw", "remainder_kernel": "run_batched",
                      "Memset (Device)": "run_batched", "index_kernel": "other",
                      "gfmm::lonely": "unknown"}


def test_busy_union_and_idle_gaps():
    tr = trace.reduce_events(_events(), HOST, (50, 2050))
    assert trace.busy_intervals(tr["device"], 50, 2050) == [
        [200, 300], [400, 700], [800, 900], [950, 970], [1000, 1100]]
    # each gap by the host range at its middle: 125, 350, 750, 925, 985, 1575
    assert trace.idle_gaps(tr) == [("draw", 150e-9), ("run_batched", 100e-9), ("wait", 100e-9),
                                   ("wait", 50e-9), ("wait", 30e-9), ("wait", 950e-9)]
    assert trace.busy_intervals(tr["device"], 250, 450) == [[250, 300], [400, 450]]


def test_host_ranges_are_kept_only_while_on():
    host = trace.HostRanges()
    with host("draw"):
        pass
    host.on = True
    with host("wait"):
        pass
    assert [r[0] for r in host.ranges] == ["wait"] and host.ranges[0][1] <= host.ranges[0][2]
    assert trace.start_profile("cpu") is None and trace.stop_profile(None) == []
