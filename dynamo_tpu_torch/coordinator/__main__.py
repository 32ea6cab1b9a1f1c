"""`python -m dynamo_tpu_torch.coordinator` — run the control-plane store.

Port of `dynamo_tpu/coordinator/__main__.py`; prints
`COORDINATOR_READY tcp://host:port` once it listens. `--faults` /
`--faults-seed` are parsed and exported as every component does
(`cli_util.export_faults`); as in the reference, the served store itself
takes no injector.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

from dynamo_tpu_torch.cli_util import (
    add_fault_args,
    export_faults,
    setup_logging,
)
from dynamo_tpu_torch.runtime.store_net import StoreServer

logger = logging.getLogger(__name__)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m dynamo_tpu_torch.coordinator",
        description="dynamo_tpu_torch control-plane coordinator "
                    "(lease KV store)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=6379)
    p.add_argument("--log-level", default="info")
    add_fault_args(p)
    args = p.parse_args(argv)
    export_faults(args)
    setup_logging(args.log_level)

    async def run():
        server = StoreServer(host=args.host, port=args.port)
        host, port = await server.start()
        # parseable readiness line for process supervisors / tests
        print(f"COORDINATOR_READY tcp://{host}:{port}", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        await server.stop()

    asyncio.run(run())


if __name__ == "__main__":
    main()
