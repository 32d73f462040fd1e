"""The network tier's server: decode batches on this host's cores and
stream them to consumers (the counterpart of the JAX package's
``tools/data_server.py``, with its options and its wire).

::

    # on each decode host (the .rec/.idx live on this host)
    python mxnet_tpu_torch/data_service/server_main.py --host 0.0.0.0 \\
        --port 9410

    # on the training host
    it = mx.io.ImageRecordIter(..., data_service='cpu1:9410,cpu2:9410')
    # or for every env-routed iterator:
    #   export MXTPU_DATA_SERVERS=cpu1:9410,cpu2:9410

The server keeps no state across connections: each consumer connection
carries its whole stream config (dataset paths as seen from this host,
shapes, seed, shard offset and stride, decode workers) in its handshake,
and the server builds a fresh ``DataService`` for it, so a server that is
killed and respawned needs no handoff: the consumer's reconnect handshake
asks for its stream at the last consumed batch.

The process never imports torch: it runs under the worker's stub package
(``_worker_main.bootstrap``), so ``mxnet_tpu_torch/__init__.py`` never
executes.
"""
import argparse
import os
import signal
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))


def _bootstrap():
    """Install the stub package and import the network tier."""
    sys.path.insert(0, _HERE)
    import _worker_main
    sys.path.remove(_HERE)
    _worker_main.bootstrap()
    from mxnet_tpu_torch.data_service import net
    return net


def _log(msg):
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="data-service network-tier server (torch-free)")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address (0.0.0.0 for remote consumers)")
    parser.add_argument("--port", type=int, default=9410,
                        help="TCP port (0 = ephemeral; see --port-file)")
    parser.add_argument("--port-file", default=None,
                        help="write 'host:port' here once listening")
    args = parser.parse_args(argv)

    net = _bootstrap()
    server = net.BatchServer(host=args.host, port=args.port, log=_log)

    def _on_signal(signum, frame):
        _log("data_server: signal %d, shutting down" % signum)
        server.shutdown()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _on_signal)

    _log("data_server: listening on %s:%d (pid %d)"
         % (server.host, server.port, os.getpid()))
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write("%s:%d" % (server.host, server.port))
        os.replace(tmp, args.port_file)
    return server.serve_forever()


if __name__ == "__main__":
    sys.exit(main())
