"""The feeder and the sink around the program's streaming path, each a
process of its own, as ffmpeg would be on either side of
``video-restore - -``:

    python -m benchmark.harness.stream feed TRAFFIC_JSON SEED
        writes the seeded y4m stream (``harness/video.py``) to its standard
        output until it is killed or the pipe breaks; the pipe stays full,
        as decoding a file keeps it.

    python -m benchmark.harness.stream sink KEEP_EVERY KEEP_FIRST
        reads an I420 y4m stream on its standard input. After each complete
        frame it writes ``F <index> <monotonic seconds>`` to its standard
        output. It keeps in memory the frames whose index i has
        ``i % KEEP_EVERY < KEEP_FIRST`` and ``i >= KEEP_EVERY`` (the first
        frames of every shot after the first). On SIGUSR1 or at the end of
        its input it closes its input (the writer then sees a broken pipe),
        writes each kept frame as ``K <index> <bytes>`` and the bytes, then
        ``E``, and exits.

Nothing streamed is written to disk.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time


class _Stop(Exception):
    pass


def _stop(signum, frame):
    raise _Stop()


def feed(traffic_path: str, seed: int) -> int:
    from benchmark.harness.video import Stream

    with open(traffic_path) as f:
        stream = Stream(json.load(f), seed)
    out = sys.stdout.buffer
    try:
        out.write(stream.header())
        i = 0
        while True:
            out.write(stream.frame(i))
            i += 1
    except BrokenPipeError:
        pass
    finally:
        try:
            out.close()
        except BrokenPipeError:
            pass
    return 0


def _read_exact(f, view) -> bool:
    """Fill ``view`` from the raw stream f; False at the end of input."""
    got = 0
    while got < len(view):
        n = f.readinto(view[got:])
        if not n:
            return False
        got += n
    return True


def sink(keep_every: int, keep_first: int) -> int:
    signal.signal(signal.SIGUSR1, _stop)
    src = open(sys.stdin.fileno(), "rb", buffering=0, closefd=False)
    out = sys.stdout.buffer
    kept = {}
    try:
        header = b""
        while not header.endswith(b"\n"):
            c = src.read(1)
            if not c:
                raise _Stop()
            header += c
        tags = {t[0]: t[1:] for t in header.decode("ascii").split()[1:]}
        w, h = int(tags["W"]), int(tags["H"])
        size = w * h * 3 // 2
        marker = bytearray(6)
        i = 0
        while True:
            if not _read_exact(src, memoryview(marker)):
                break
            if bytes(marker) != b"FRAME\n":
                raise ValueError(f"sink: frame {i} lacks its FRAME marker")
            buf = bytearray(size)
            if not _read_exact(src, memoryview(buf)):
                break
            t = time.monotonic()
            if i >= keep_every and i % keep_every < keep_first:
                kept[i] = buf
            # a report line is written whole: the stop signal waits for it
            signal.pthread_sigmask(signal.SIG_BLOCK, [signal.SIGUSR1])
            out.write(b"F %d %.9f\n" % (i, t))
            out.flush()
            signal.pthread_sigmask(signal.SIG_UNBLOCK, [signal.SIGUSR1])
            i += 1
    except _Stop:
        pass
    finally:
        signal.signal(signal.SIGUSR1, signal.SIG_IGN)
        os.close(sys.stdin.fileno())
    for i, buf in sorted(kept.items()):
        out.write(b"K %d %d\n" % (i, len(buf)))
        out.write(buf)
    out.write(b"E\n")
    out.flush()
    return 0


def main(argv) -> int:
    if argv[0] == "feed":
        return feed(argv[1], int(argv[2]))
    if argv[0] == "sink":
        return sink(int(argv[1]), int(argv[2]))
    raise SystemExit(f"unknown role {argv[0]!r}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
