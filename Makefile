# Convenience targets. Tests force the CPU backend with a simulated
# 8-device mesh (tests/conftest.py); bench and smoke need the GPU and
# fail without it.

.PHONY: test test-fast test-gpu bench smoke scaling configs native

test:
	python -m pytest tests/ -q

test-fast:
	python -m pytest tests/unit tests/integration -q

test-gpu:
	MAXWELL_TEST_GPU=1 python -m pytest tests/ -q -m gpu

bench:
	python bench.py

smoke:
	python chip_smoke.py

scaling:
	python -m maxwell_tpu.bench.scaling --mode weak

configs:
	for c in configs/config*.json; do \
	  echo "== $$c"; python -m maxwell_tpu.cli.run $$c | tail -1; done

native:
	python -c "from maxwell_tpu import native; print('HAVE_NATIVE =', native.HAVE_NATIVE)"
