"""How the window offers its requests, one file a traffic mix's ``loop``
(``benchmark/loops/<loop>.py``). Each exposes ``drive(one_round, mix,
seconds) -> rounds``: it calls ``one_round(r)`` for r = 0, 1, ... as its
arrivals say until ``seconds`` have passed, and refuses a mix whose
parameters it does not implement."""
