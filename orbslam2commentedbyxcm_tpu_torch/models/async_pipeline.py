"""The asynchronous pipeline: local mapping and loop closing on worker threads.

Counterpart of orbslam2commentedbyxcm_tpu/models/async_pipeline.py. The
reference runs LocalMapping and LoopClosing on their own threads (spawned in
src/System.cc:98-111), with a keyframe queue capped at 3
(src/Tracking.cc:1173) and the map-wide Map::mMutexMapUpdate serializing
tracking against map changes (include/Map.h:114). Here:

  * `AsyncMapping`: a worker drains a keyframe queue into the wrapped
    LocalMapping under `map_lock`. Backpressure is the reference's: the
    keyframe policy asks `accepts_keyframes()` (fewer than QUEUE_CAP queued),
    an insertion raises the local BA's abort flag (mbAbortBA), and fuse, BA
    and culling wait while newer keyframes are queued (`pending_check`, the
    CheckNewKeyFrames() gates).
    The worker holds `map_lock` for a whole keyframe, where the reference's
    LocalMapping takes the map mutex only around local BA's write-back
    (Optimizer::LocalBundleAdjustment); so a keyframe queued by one frame
    is taken up by the worker before the next frame is tracked
    (`wait_taken`, called by the System before it takes the lock for a
    frame). Without that hand-off
    the order was a race between the woken worker and the tracking thread
    taking the lock again, which it does within a millisecond once
    extraction is four kernel launches: the worker could wait several
    frames, and the figure-eight's map and loop changed from run to run.
  * `AsyncLoopClosing`: a second worker, fed by the mapping stage. The BoW
    transform (`prepare_keyframe`) and the Sim3 phase (`try_close`, on a
    snapshot) run without the map lock; detection, the snapshot and the
    correction (`finalize`) take it. Global BA still runs on its own
    transient thread (models/gba).

Every other attribute reads and writes through to the wrapped stage, so the
System wires a wrapper as it would the stage (paused, relocalizer, map).

One divergence from the JAX package: an exception in a stage is kept and
raised again by `wait_idle()` and `shutdown()` (the worker keeps draining the
queue meanwhile, so neither hangs), as GlobalBA.wait() does; the JAX workers
only print it, so a run with a dead stage would pass.

On CUDA the workers launch onto the default stream, as the tracking thread
and global BA do: the card runs the three threads' kernels in issue order,
and a host read on one thread waits for the others' kernels enqueued before.
"""

from __future__ import annotations

import queue
import threading

QUEUE_CAP = 3  # reference src/Tracking.cc:1173


class _AsyncStage:
    """Worker-thread wrapper: drains a keyframe queue into the wrapped stage.
    A stage exception is kept for wait_idle / shutdown, and the worker goes
    on draining."""

    _OWN = {"inner", "lock", "_queue", "_thread", "_errors", "max_depth", "name"}

    def __init__(self, inner, map_lock: threading.Lock, name: str):
        object.__setattr__(self, "inner", inner)
        object.__setattr__(self, "lock", map_lock)
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "_queue", queue.Queue())
        object.__setattr__(self, "_errors", [])
        object.__setattr__(self, "max_depth", 0)  # deepest the queue got
        t = threading.Thread(target=self._run, daemon=True, name=name)
        object.__setattr__(self, "_thread", t)
        t.start()

    # -- delegation ----------------------------------------------------------

    def __getattr__(self, k):
        return getattr(self.inner, k)

    def __setattr__(self, k, v):
        if k in _AsyncStage._OWN:
            object.__setattr__(self, k, v)
        else:
            setattr(self.inner, k, v)

    # -- worker --------------------------------------------------------------

    def _run(self):
        while True:
            kf_id = self._queue.get()
            try:
                if kf_id is None:
                    return
                self._process(kf_id)
            except Exception as exc:  # kept, traceback and all, for wait_idle / shutdown
                self._errors.append(exc)
            finally:
                self._queue.task_done()

    def _process(self, kf_id: int):
        with self.lock:
            self.inner.insert_keyframe(kf_id)

    def insert_keyframe(self, kf_id: int):
        """Enqueue; never blocks (the caller holds map_lock: backpressure
        comes from the keyframe policy, not the queue)."""
        self._queue.put(kf_id)
        self.max_depth = max(self.max_depth, self._queue.qsize())

    def wait_idle(self):
        """Block until every queued keyframe has been processed, then raise
        what the stage raised meanwhile. Do not call while holding the map
        lock (the worker takes it)."""
        if threading.current_thread() is not self._thread:
            self._queue.join()
        self._raise_error()

    def shutdown(self):
        """Drain, end and join the worker; raise what the stage raised."""
        if self._thread.is_alive():
            self._queue.put(None)
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=300)
            if self._thread.is_alive():
                raise RuntimeError(f"the {self.name} worker did not end within 300 s")
        self._raise_error()

    def _raise_error(self):
        if self._errors:
            err = self._errors.pop(0)
            self._errors.clear()
            raise RuntimeError(f"the {self.name} stage failed on its worker thread") from err


class AsyncMapping(_AsyncStage):
    def __init__(self, inner, map_lock: threading.Lock):
        object.__setattr__(self, "_handoff", threading.Condition())
        object.__setattr__(self, "_counts", [0, 0])  # keyframes queued, keyframes taken up by the worker
        super().__init__(inner, map_lock, "local-mapping")
        # the wrapped stage defers fuse / BA / culling while newer keyframes
        # are queued (reference CheckNewKeyFrames, src/LocalMapping.cc:63-71)
        inner.pending_check = lambda: not self._queue.empty()

    def _process(self, kf_id: int):
        with self.lock:
            with self._handoff:
                self._counts[1] += 1
                self._handoff.notify_all()
            self.inner.insert_keyframe(kf_id)

    def insert_keyframe(self, kf_id: int):
        """Signal a running local BA to stop (LocalMapping::InsertKeyFrame sets
        mbAbortBA, src/LocalMapping.cc:117) and enqueue."""
        self.inner.abort_ba = True
        with self._handoff:
            self._counts[0] += 1
        super().insert_keyframe(kf_id)

    def wait_taken(self):
        """Block until the worker has taken up (holds, or has released, the
        map lock for) every keyframe queued so far. Call without the map
        lock: the worker needs it."""
        with self._handoff:
            self._handoff.wait_for(lambda: self._counts[1] >= self._counts[0])

    def accepts_keyframes(self) -> bool:
        """LocalMapping::AcceptKeyFrames as the queue-cap check."""
        return self._queue.qsize() < QUEUE_CAP

    def initial_ba(self, kf1_id: int, kf2_id: int):
        # synchronous, as the reference's CreateInitialMapMonocular: it runs
        # on the tracking thread, which already holds the map lock
        self.inner.initial_ba(kf1_id, kf2_id)


class AsyncLoopClosing(_AsyncStage):
    """LoopClosing on its own worker (reference src/System.cc:105-111): the
    mapping stage hands keyframes to this queue and returns at once. The map
    lock is held only for detection, the snapshot and the correction, as the
    reference takes the map mutex only in CorrectLoop
    (src/LoopClosing.cc:497)."""

    def __init__(self, inner, map_lock: threading.Lock):
        super().__init__(inner, map_lock, "loop-closing")

    def _process(self, kf_id: int):
        kf = self.inner.prepare_keyframe(kf_id)  # no map lock: the BoW transform
        if kf is None:
            return
        with self.lock:
            candidates = [] if kf.bad else self.inner.detect_candidates(kf)
            snapshot = self.inner.snapshot_for_closure(kf, candidates) if candidates else None
        # the Sim3 phase, usually a rejection: outside the lock, on the
        # snapshot (the mapping worker goes on changing the live map)
        found = self.inner.try_close(kf, candidates, snapshot=snapshot) if candidates else None
        with self.lock:
            if not kf.bad:  # it may have been culled meanwhile
                self.inner.finalize(kf, found)
