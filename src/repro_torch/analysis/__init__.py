"""Plan conformance of the port (counterpart of ``repro.analysis``): the
record of the collectives a step issues (:mod:`.signature`), which tests hold
against the reference's ``repro.analysis.expect.expected_signature``."""
