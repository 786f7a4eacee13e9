"""Host→device streaming: ring-buffered uploads overlapping device compute.

The device equivalent of the reference's zero-copy transferable handoff
(src/V1/worker.ts:58-69, DRACOLoader.js:445-449 — ownership moves, no
copies on the render thread): `jax.device_put` is asynchronous, so
enqueueing the NEXT window's upload before consuming the current one
overlaps the host-to-device transfer with device compute. The ring keeps a bounded
number of windows resident (the V1/V2 players' buffer windows, expressed
as device memory instead of browser heap).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple


class DeviceRingBuffer:
    """Fixed number of device-resident slots keyed by a monotonically
    increasing window index; old windows are evicted as new ones land
    (mirrors removePlayedBuffer's eviction, src/V2/player.ts:548-562)."""

    def __init__(self, num_slots: int = 2, device: Any = None):
        import jax

        self.num_slots = num_slots
        self.device = device or jax.devices()[0]
        self._slots: Dict[int, Any] = {}

    def put(self, index: int, host_tree: Any) -> Any:
        """Start the async upload of a window; returns the device tree."""
        import jax

        dev = jax.device_put(host_tree, self.device)
        self._slots[index] = dev
        # evict windows older than the ring capacity
        for k in sorted(self._slots):
            if k <= index - self.num_slots:
                del self._slots[k]
        return dev

    def get(self, index: int) -> Optional[Any]:
        return self._slots.get(index)

    def __len__(self) -> int:
        return len(self._slots)


def stream_frames(
    frames: Iterable[Any],
    step_fn: Callable[[Any], Any],
    *,
    num_slots: int = 2,
    device: Any = None,
) -> Iterator[Tuple[int, Any]]:
    """Double-buffered pipeline: while the device computes `step_fn` on
    window i, window i+1's upload is already in flight.

    Yields (index, result) in order. With jit-compiled `step_fn` the
    dispatch is also async, so the host stays ahead of the device by one
    window — transfer, compute, and host iteration all overlap.
    """
    ring = DeviceRingBuffer(num_slots=num_slots, device=device)
    it = enumerate(iter(frames))
    pending = []  # [(index, device_tree)]
    for idx, host in it:
        pending.append((idx, ring.put(idx, host)))
        if len(pending) >= 2:
            i0, dev0 = pending.pop(0)
            yield i0, step_fn(dev0)  # upload of pending[0] overlaps this
    for i0, dev0 in pending:
        yield i0, step_fn(dev0)
