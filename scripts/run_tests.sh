#!/bin/sh
# Run the test suite on the CPU: an 8-device virtual CPU mesh for the
# multi-device tests, the Triton decode kernel in the Pallas interpreter.
cd "$(dirname "$0")/.." || exit 1
JAX_PLATFORMS=cpu \
XLA_FLAGS="--xla_force_host_platform_device_count=8" \
exec python -m pytest tests/ -q -m 'not slow' "$@"
