"""Walks of a pair of states per program: the port's counter ``pair_walks``
(one a call of ``ops/measure.py pauli_pair_sums``, one pass over the pair
for one flip mask) over the window's programs. An exact count: QAOA
MaxCut's adjoint gradient walks once a cost layer and once a qubit of each
mixer layer, p (n + 1). None where the port counts no walks."""

from qbench.spans import counter


def read(record):
    walks, n = counter("pair_walks"), record["programs"]
    return walks / n if walks and n else None
