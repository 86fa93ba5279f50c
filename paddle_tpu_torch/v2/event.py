"""v2 training events, the port of ``paddle_tpu/v2/event.py`` (reference
python/paddle/v2/event.py)."""


class BeginPass:
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass:
    def __init__(self, pass_id, evaluator=None):
        self.pass_id = pass_id
        self.evaluator = evaluator


class BeginIteration:
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration:
    def __init__(self, pass_id, batch_id, cost, metrics=None):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost
        self.metrics = metrics or {}


class TestResult:
    def __init__(self, cost, metrics=None):
        self.cost = cost
        self.metrics = metrics or {}
