"""The port's share of the reference's analysis package: the conclint
runtime witness only (`analysis.conc.witness`), which simnet's harness
installs for SIM110. The static linters (detlint, conclint) stay the
reference's and are run over the port by tests/test_torch_lints.py."""
