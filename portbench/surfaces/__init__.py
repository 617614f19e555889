"""Surfaces beyond the packet path: ``surfaces/<surface>.py`` runs every
cell whose configuration names that ``surface``, through its ``run``
(the signature and result of ``bench.run``), and states in ``ROWS`` the
``rows`` of the traffic mixes it takes."""
