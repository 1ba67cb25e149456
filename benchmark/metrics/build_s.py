"""Host seconds of ``operator_from_coo`` (the host containers, the card
form, the transfer), ended by a synchronise."""


def read(run):
    return run.stages.get("build")
