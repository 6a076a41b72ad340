"""Seconds of formats/synthetic.train_pq plus formats/accel.encode_pq in
set-up (host clock, the card synchronised); None without PQ. Layer:
formats. Moves: setup_s."""


def read(rec):
    if "pq_train" not in rec.setup:
        return None
    return rec.setup["pq_train"] + rec.setup["pq_encode"]
