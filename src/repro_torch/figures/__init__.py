"""The runner functions of the paper's Figs. 2-7 through the port (twins
of ``benchmarks/common.py`` and ``benchmarks/fig{2..7}_*.py``).

Each is the reference's runner with the same defaults and a ``device=``
(``None`` means ``"cuda"``); the golden fixtures ``tests/golden/fig{2..7}
.json`` hold their tiny regimes.  They return numbers and write nothing:
the figures' CSVs and the benchmark scripts stay with the reference.
"""
