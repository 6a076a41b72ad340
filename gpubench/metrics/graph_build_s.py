"""Seconds of formats/vamana.build_vamana_graph in set-up (host clock, the
card synchronised). Layer: formats. Moves: setup_s."""


def read(rec):
    return rec.setup.get("graph")
