#!/usr/bin/env python3
"""The interpreter the Java binding spawns, standing in for ``python3``.

The Java ``CylonContext.init(backend)`` starts

    <cylon.gateway.python> -m pycylon.java_gateway <backend>

(java/src/main/java/org/cylondata/cylon/CylonContext.java).  Naming this
file as that interpreter,

    java -Dcylon.gateway.python=/path/to/cylon_tpu_torch/pycylon/java_launcher.py ...

runs the PyTorch engine's gateway (``cylon_tpu_torch.pycylon.java_gateway``)
with that backend, on the card, at the default world, with the Java
binding unchanged.  Flags after the backend pass through to the gateway
(``--device cpu``, ``--world N``).  Any other ``-m`` target, or none,
exits with code 2 and a message on stderr.
"""
import os
import sys

GATEWAY_MODULE = "pycylon.java_gateway"


def main(argv) -> int:
    if len(argv) < 2 or argv[0] != "-m" or argv[1] != GATEWAY_MODULE:
        print(f"java_launcher: runs only '-m {GATEWAY_MODULE} [backend] "
              f"[--device D] [--world N]', got {argv!r}", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    # the launcher's own directory holds packages named io, net, util …:
    # keep it off the import path, and put the package's root on it
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or os.curdir) != here]
    sys.path.insert(0, os.path.dirname(os.path.dirname(here)))
    from cylon_tpu_torch.pycylon import java_gateway
    return java_gateway.main(argv[2:])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
