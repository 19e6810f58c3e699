"""Mean over the rounds of a traced run's steady part of occupied lanes
over slots, from the program's ``stepwise.step`` spans."""


def read(run):
    if not run.occupancy:
        return None
    return sum(run.occupancy) / len(run.occupancy)
