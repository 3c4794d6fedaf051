"""conclint's runtime witness for the port (`witness.py`, a renamed
copy of the reference's): instrumented lock wrappers and sampled
shared-attribute writes that simnet's SIM110 audits."""
