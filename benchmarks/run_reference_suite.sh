#!/usr/bin/env bash
# Run the reference package's own pytest suite against the wlsqm/ shim.
#
# The shim (wlsqm/ at the repo root) re-exports the full compatibility
# surface from wlsqm_tpu, so the reference's behavioral tests run
# unmodified.  tests/test_cimport.py is deselected: it checks for Cython
# build artifacts (.pxd headers, generated VERSION, cimport-compilability)
# that a Cython-free rebuild intentionally does not produce — it tests the
# reference's build system, not wlsqm behavior.
#
# Usage:  benchmarks/run_reference_suite.sh [path-to-reference]
# Expected result: 46 passed.
#
# The suite is a BEHAVIORAL check, so it runs on the host CPU by default;
# set JAX_PLATFORMS to drive it on a device instead.
set -euo pipefail

export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"

REF="${1:-/root/reference}"
if [ "$#" -gt 0 ]; then shift; fi
REPO="$(cd "$(dirname "$0")/.." && pwd)"

if [ ! -d "$REF/tests" ]; then
    echo "reference tests not found under $REF" >&2
    exit 1
fi

cd "$REPO"
exec python -m pytest "$REF/tests" \
    --ignore="$REF/tests/test_cimport.py" \
    -q "$@"
