#!/usr/bin/env bash
# One-command gate for a fresh clone (mirror of the reference's
# tickbox/precommit scripts, e.g. 40-test-all-features.sh).
#
#   ./precommit.sh          # full: suite + dryrun + rehearsals
#   ./precommit.sh --quick  # suite only
#
# Everything runs on CPU (8 virtual devices) — no GPU required; the
# rehearsals run the GPU scripts at tiny sizes with interpreted kernels.
set -euo pipefail
cd "$(dirname "$0")"

quick=0
[[ "${1:-}" == "--quick" ]] && quick=1

echo "== native build =="
make -C native >/dev/null

echo "== test suite (CPU, 8 virtual devices) =="
python -m pytest tests/ -q -x

if [[ $quick -eq 0 ]]; then
  echo "== multichip dryrun (8 virtual CPU devices) =="
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

  echo "== graft entry compile check =="
  JAX_PLATFORMS=cpu python - <<'EOF'
import jax
import __graft_entry__ as g
fn, args = g.entry()
jax.jit(fn).lower(*args).compile()
print("entry() compiles")
EOF

  echo "== bench and chip smoke rehearsals (CPU, tiny sizes) =="
  JAX_PLATFORMS=cpu python bench.py --rehearse
  JAX_PLATFORMS=cpu python chip_smoke.py --rehearse
fi

echo "precommit OK"
