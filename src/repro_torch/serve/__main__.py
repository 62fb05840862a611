"""Stdin/socket driver for the simulation server (port of
``python -m repro.serve``).

``python -m repro_torch.serve [--chunk-ticks 16] [--slot-widths 4,8]
[--max-in-flight 32] [--port 7351] [--device cuda]``

Without ``--port``, speaks the JSON-lines protocol on stdin/stdout —
pipe a script of ops in, read responses out (see
``repro_torch/serve/protocol.py`` for the op set)::

    printf '%s\n' \
      '{"op":"register_surrogate","name":"lif","train":{"circuit":"lif","n_runs":60}}' \
      '{"op":"register_spec","name":"net","snn":{"weights":[...],"params":[...]}}' \
      '{"op":"simulate","spec":"net","surrogate":"lif","stimulus_spikes":{"t":24,"b":2}}' \
      '{"op":"shutdown"}' | python -m repro_torch.serve

With ``--port``, accepts TCP connections one at a time and runs the same
loop per connection (``shutdown`` ends the connection; Ctrl-C ends the
server). The in-process API (``lasana.serve()``) is the primary
interface; this driver exists so the service can be scripted from
anything that can write JSON to a pipe or socket. The server runs on
``--device`` (default ``cuda``, which raises where there is no card;
``--device cpu`` runs the plain versions).
"""

from __future__ import annotations

import argparse
import sys


def serve(args) -> dict:
    import repro_torch.lasana as lasana
    from repro_torch.serve.protocol import run_stdio

    widths = tuple(int(w) for w in str(args.slot_widths).split(",") if w)
    server = lasana.serve(chunk_ticks=args.chunk_ticks,
                          slot_widths=widths,
                          max_in_flight=args.max_in_flight,
                          max_queue=args.max_queue,
                          device=args.device)
    handled = 0
    try:
        if args.port:
            import socket
            lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            lsock.bind((args.host, args.port))
            lsock.listen(1)
            print(f"[serve] listening on {args.host}:{args.port}",
                  file=sys.stderr)
            try:
                while True:
                    conn, peer = lsock.accept()
                    print(f"[serve] client {peer}", file=sys.stderr)
                    with conn, conn.makefile("r") as fin, \
                            conn.makefile("w") as fout:
                        handled += run_stdio(server, fin, fout)
            except KeyboardInterrupt:
                pass
            finally:
                lsock.close()
        else:
            handled = run_stdio(server, sys.stdin, sys.stdout)
    finally:
        server.close()
    stats = server.stats()
    print(f"[serve] handled {handled} ops, "
          f"{stats['requests_completed']} requests, "
          f"{stats['compile_count']} compiled programs, "
          f"occupancy {stats['batch_occupancy']:.2f}", file=sys.stderr)
    return {"handled": handled, "stats": stats}


def main():
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--chunk-ticks", type=int, default=16)
    ap.add_argument("--slot-widths", default="4",
                    help="comma ladder of batch widths, e.g. 4,8")
    ap.add_argument("--max-in-flight", type=int, default=32)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port (default: stdin/stdout)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda",
                    help="where the server runs (cpu: the plain versions)")
    args = ap.parse_args()
    serve(args)


if __name__ == "__main__":
    main()
