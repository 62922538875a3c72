# Common entry points.  The test suite forces an 8-virtual-device CPU mesh
# itself (tests/conftest.py); chip_smoke, bench and the benchmarks use the
# default device (the GPU when present).

.PHONY: test test-slow reference-suite smoke smoke-four bench examples dryrun bench-ibvp

test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -q

test-slow:
	JAX_PLATFORMS=cpu WLSQM_TPU_RUN_SLOW=1 python -m pytest tests/ -q

reference-suite:               # the reference package's own tests vs the shim
	benchmarks/run_reference_suite.sh

smoke:                         # the public fit path on one GPU, with parity
	python chip_smoke.py

smoke-four:                    # the sharded path on four GPUs
	python chip_smoke.py --four

bench:                         # headline fits/s; prints one JSON line
	python bench.py

bench-ibvp:                    # IBVP stepping vs fields; u[idx] gather rate
	python benchmarks/run_ibvp_multifield.py

dryrun:                        # multi-device sharding on a virtual CPU mesh
	python -c "import __graft_entry__ as g; g.dryrun_multichip(8); print('OK')"

examples:
	JAX_PLATFORMS=cpu python examples/wlsqm_tour.py
	JAX_PLATFORMS=cpu python examples/ibvp_heat.py
	JAX_PLATFORMS=cpu python examples/response_surface.py
	JAX_PLATFORMS=cpu python examples/distributed_pipeline.py
	JAX_PLATFORMS=cpu python examples/sudoku_lhs.py
	JAX_PLATFORMS=cpu JAX_NUM_CPU_DEVICES=8 python examples/jit_plan_sharding.py
	JAX_PLATFORMS=cpu python examples/gradient_stencil_design.py
	JAX_PLATFORMS=cpu python examples/adjoint_data_recovery.py
