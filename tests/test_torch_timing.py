"""The tuner's card timer (search/kernel_tuner.py::cuda_seconds) on a
simulated stream: the host enqueues work with a cost per call, the device
runs it in order, events read the device's clock. The arithmetic is the
one the card runs; only the clock is simulated."""

from collections import deque

import pytest

from vae_extent_search_tpu_torch.search import kernel_tuner as kt


class FakeClock:
    """A stream: ``host`` is the host's clock, ``busy`` when the device is
    done with what was enqueued; an op starts when it is enqueued and the
    device is free. ``depth`` bounds the queue of pending ops (the host
    waits for the oldest when it is full)."""

    def __init__(self, blocker_ms=3.0, depth=None):
        self.now = 0.0
        self.busy = 0.0
        self.blocker = blocker_ms
        self.depth = depth
        self.pending = deque()
        self.calls = 0

    def _enqueue(self, dev_ms, host_ms):
        self.now += host_ms
        if self.depth is not None:
            while self.pending and self.pending[0] <= self.now:
                self.pending.popleft()
            if len(self.pending) >= self.depth:
                self.now = self.pending.popleft()
        self.busy = max(self.busy, self.now) + dev_ms
        if self.depth is not None:
            self.pending.append(self.busy)

    def host(self):
        return self.now / 1e3

    def event(self):
        self._enqueue(0.0, 0.0)
        return self.busy

    @staticmethod
    def elapsed_ms(a, b):
        return b - a

    def sync(self):
        self.now = max(self.now, self.busy)

    def block(self, n):
        for _ in range(n):
            self._enqueue(self.blocker, 0.005)

    def blocker_ms(self):
        return self.blocker

    def kernel(self, dev_ms, host_ms, launches=1):
        """A call that costs the host ``host_ms`` (a callable of the call's
        index, or a number) and launches ``launches`` ops of ``dev_ms``."""
        def fn():
            h = host_ms(self.calls) if callable(host_ms) else host_ms
            self.calls += 1
            for i in range(launches):
                self._enqueue(dev_ms / launches, h if i == 0 else 0.0)
        return fn


@pytest.mark.parametrize("dev_ms,host_ms", [
    (0.004, 0.035),    # a segment sum: the host is 9x slower than the card
    (0.0194, 0.0238),  # the tensor-core matmul at 1536^3
    (0.5, 0.03),       # the CUDA-core matmul: the card is the slower
    (2.0, 0.02)])
def test_reads_the_device_not_the_host(dev_ms, host_ms):
    clock = FakeClock()
    t = kt.cuda_seconds(clock.kernel(dev_ms, host_ms), clock=clock)
    assert t.seconds == pytest.approx(dev_ms / 1e3, rel=1e-9)
    assert t.host_seconds == pytest.approx(host_ms / 1e3, rel=1e-9)


def test_back_to_back_would_read_the_host():
    # what the timer replaces: events around calls enqueued back to back
    clock = FakeClock()
    fn = clock.kernel(0.004, 0.035)
    a = clock.event()
    for _ in range(100):
        fn()
    b = clock.event()
    assert clock.elapsed_ms(a, b) / 100 == pytest.approx(0.035, rel=2e-3)


@pytest.mark.parametrize("dev_ms,host_ms,target,iters", [
    (0.02, 0.03, 10.0, 200),    # capped by MAX_CALLS
    (0.5, 0.03, 10.0, 20),      # target / device ms
    (0.02, 1.0, 10.0, 40),      # MAX_HOST_MS / host ms
    (50.0, 0.02, 10.0, 1)])     # at least one
def test_window_size(dev_ms, host_ms, target, iters):
    clock = FakeClock()
    kt.cuda_seconds(clock.kernel(dev_ms, host_ms), target_ms=target,
                    repeats=3, warmup=2, clock=clock)
    # warm-up, the host probe, the first window, then three windows
    assert clock.calls == 2 + kt.PROBE_CALLS + kt.PROBE_CALLS + 3 * iters


def test_minimum_over_repeats():
    # the device time of the second window is the shortest
    clock = FakeClock()
    times = iter([0.03] * 12 + [0.05] * 200 + [0.02] * 200 + [0.04] * 200)
    fn = clock.kernel(0.0, 0.01)

    def call():
        fn()
        clock.busy += next(times)

    t = kt.cuda_seconds(call, clock=clock)
    assert t.seconds == pytest.approx(0.02e-3)


def test_a_slower_host_is_retried_with_a_longer_blocker():
    # the probe saw 0.01 ms per call, the windows take 0.05: each window's
    # first blocker is too short, the retry's is sized to what it measured
    clock = FakeClock()
    t = kt.cuda_seconds(clock.kernel(
        0.02, lambda i: 0.01 if i < 2 + kt.PROBE_CALLS else 0.05),
        clock=clock)
    assert t.seconds == pytest.approx(0.02e-3)
    assert t.host_seconds == pytest.approx(0.05e-3)


def test_raises_when_the_host_falls_behind():
    # the probe and its window see 0.01 ms per call, the first full window
    # 5 ms, its retry 50 ms: the retry's blocker (sized to 5 ms per call)
    # ends while the host is still enqueueing
    first = 2 + 2 * kt.PROBE_CALLS
    clock = FakeClock()
    with pytest.raises(RuntimeError, match="still enqueueing"):
        kt.cuda_seconds(clock.kernel(
            0.02, lambda i: 0.01 if i < first
            else 5.0 if i < first + kt.MAX_CALLS else 50.0), clock=clock)


def test_raises_when_the_launch_queue_fills():
    # four launches per call and a queue of 100: the host waits for the
    # device, inside the blocker, and the timer refuses the window
    clock = FakeClock(depth=100)
    with pytest.raises(RuntimeError, match="still enqueueing"):
        kt.cuda_seconds(clock.kernel(0.02, 0.01, launches=4), clock=clock)
    # one launch per call stays within the queue at MAX_CALLS
    clock = FakeClock(depth=kt.MAX_CALLS + 16)
    t = kt.cuda_seconds(clock.kernel(0.02, 0.01), clock=clock)
    assert t.seconds == pytest.approx(0.02e-3)
