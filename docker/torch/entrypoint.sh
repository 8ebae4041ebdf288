#!/bin/sh
# Role dispatch for the port's runtime image: each role runs as
# ``python -m langstream_tpu_torch.entrypoint <role>`` (entrypoint.main),
# the command the port's manifests give every container. Anything else is
# run as a command (``docker run <image> python ...``).
set -e
ROLE="${1:-agent-runtime}"
shift 2>/dev/null || true

case "$ROLE" in
  agent-runtime|control-plane|gateway|run-local|operator|deployer-runtime|application-setup|agent-code-download)
    exec python -m langstream_tpu_torch.entrypoint "$ROLE" "$@"
    ;;
  *)
    exec "$ROLE" "$@"
    ;;
esac
