# Developer entry points (reference analog: Makefile build/develop/test,
# /root/reference/Makefile:5-13).
.PHONY: develop test test-fast bench bench-suite smoke clean

develop:
	pip install -e .

test:
	python -m pytest tests/ -q

test-fast:
	python -m pytest tests/ -q -x -k "not duplex"

bench:
	python bench.py

bench-suite:
	python tests/benchmark.py

# the main path on a GPU; exits non-zero without one
smoke:
	python chip_smoke.py

clean:
	rm -rf build dist *.egg-info
	find . -name __pycache__ -type d -exec rm -rf {} +
