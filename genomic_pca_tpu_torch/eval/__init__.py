"""Measurement and evaluation scripts for the port.

On the card's host: `mma2d_ab`, `profile_core`, `multichip`, the oracle
CLI `exact`, `sweep_run`, `make_1000g_like` and `diskbench`.  On a host
with pandas, scikit-learn and matplotlib: `sweep_analyze`, `metrics`,
`plot` and `video`.  `subset` needs only the standard library."""
