"""Serve an exported model over HTTP with bucketed micro-batching.

Usage::

    python -m endoscopy_tpu_torch.cli.serve --model model.pt \
        [--host 0.0.0.0] [--port 8000] [--buckets 1,2,4,8,16,32] \
        [--max-wait-ms 5] [--no-warmup] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import signal

from endoscopy_tpu_torch.serve.server import make_server


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True,
                        help="path to a cli.export_model artifact")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--buckets", default="1,2,4,8,16,32",
                        help="comma-separated batch buckets to warm and "
                             "serve (ignored for pinned-batch artifacts)")
    parser.add_argument("--max-wait-ms", type=float, default=5.0,
                        help="batching linger after the first queued "
                             "request")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip running the buckets before serving")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    buckets = tuple(int(b) for b in args.buckets.split(",") if b)
    server = make_server(args.model, host=args.host, port=args.port,
                         buckets=buckets, max_wait_ms=args.max_wait_ms,
                         warmup=not args.no_warmup, device=args.device)
    c = server.contract
    print(f"serving {args.model} on {args.host}:{server.server_address[1]} "
          f"[{c['backend']}] — input {c['input_size']}px, "
          f"{c['num_classes']} classes, buckets {c['buckets']}, "
          f"linger {args.max_wait_ms}ms")

    # SIGTERM raises out of serve_forever so the finally drains the batcher
    def _on_term(signum, frame):
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _on_term)
    try:
        server.serve_forever()
    except (KeyboardInterrupt, SystemExit):
        print("shutting down")
    finally:
        server.close()


if __name__ == "__main__":
    main()
