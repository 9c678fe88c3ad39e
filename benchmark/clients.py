"""The serving clients, in a process of their own so that their work never
takes the server's interpreter lock: a closed loop of ``n`` clients, each
posting the next region of the schedule and waiting for the reply, until
the window ends. The requests in flight then are waited for. Imports no
more than the standard library; talks to its parent over one two-way pipe
(no semaphores, so nothing in shared memory)."""

from __future__ import annotations

import sys
import threading
import time
import urllib.error
import urllib.request


def closed_loop(url: str, bodies: list, schedule: list, n: int, seconds: float, conn, hold: bool = False) -> None:
    """Sends ``("started", t0)`` on ``conn`` when the first requests go out,
    then ``("done", {"start": t0, "requests": [...]})``. With ``hold`` the
    window ends at ``seconds`` or once the parent's ``("release",)`` has come
    (or its end of the pipe has closed), whichever is later."""
    released = threading.Event()

    def wait_for_release():
        try:
            conn.recv()
        except (EOFError, OSError):
            pass
        released.set()

    if hold:
        threading.Thread(target=wait_for_release, daemon=True).start()
    else:
        released.set()
    lock = threading.Lock()
    nxt = [0]
    records = []
    t0 = time.monotonic()
    deadline = t0 + seconds

    def client():
        while True:
            with lock:
                if (time.monotonic() >= deadline and released.is_set()) or nxt[0] >= len(schedule):
                    return
                k = nxt[0]
                nxt[0] += 1
            region = schedule[k]
            req = urllib.request.Request(url, data=bodies[region], headers={"Content-Type": "image/png"})
            sent = time.monotonic()
            try:
                with urllib.request.urlopen(req, timeout=600) as resp:
                    status, body = resp.status, resp.read()
            except urllib.error.HTTPError as exc:
                status, body = exc.code, b""
            except OSError:
                status, body = -1, b""
            rec = {"k": k, "region": region, "sent": sent, "end": time.monotonic(), "status": status, "body": body}
            with lock:
                records.append(rec)

    threads = [threading.Thread(target=client) for _ in range(n)]
    conn.send(("started", t0))
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if nxt[0] >= len(schedule):
        print("the schedule ran out before the window ended", file=sys.stderr, flush=True)
    records.sort(key=lambda r: r["k"])
    conn.send(("done", {"start": t0, "requests": records}))
    conn.close()
