"""Closed-loop clients: ``clients`` of them, client c sending its first
request ``c * stagger_s`` seconds after the traffic starts (``stagger_s`` 0
when the mix leaves it out), and each sending its next request the moment
the previous one's result comes back."""


class Arrivals:
    """The sends of one run: ``first(horizon_s)`` the ones known in
    advance, ``after(client, at_s)`` the one a finished request brings
    (None for none).  Times are seconds from the traffic's start."""

    def __init__(self, mix: dict, seed: int):
        self.clients = int(mix["clients"])
        self.stagger = float(mix.get("stagger_s", 0.0))

    def first(self, horizon_s: float):
        return [(c * self.stagger, c) for c in range(self.clients)
                if c * self.stagger < horizon_s]

    def after(self, client: int, at_s: float):
        return at_s, client
