"""API layer (`BatchedDetector.process_chunk`): host ms from the hand-over
of a chunk's PCM to the call's return, averaged over the window's chunks.
The benchmark's own span around each call, on the host clock."""


def read(run):
    ms = run.window.api_ms
    return sum(ms) / len(ms) if ms else None
