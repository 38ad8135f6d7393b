"""Learning-rate schedules.

Port of ``deepspeed_tpu/runtime/lr_schedules.py`` (pure Python, copied so
the port imports nothing of the JAX package): ``LRRangeTest``,
``OneCycle``, ``WarmupLR``, ``WarmupDecayLR``, instantiable by name from
the JSON config, each a stateful object with the torch-style
``step()/get_lr()/get_last_lr()/state_dict()/load_state_dict()`` API. The
engine reads the schedule's LR on the host and hands it to every
optimizer update.
"""

import math

from deepspeed_tpu_torch.utils.logging import logger

LR_SCHEDULE = "lr_schedule"
LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]

LR_RANGE_TEST_MIN_LR = "lr_range_test_min_lr"
LR_RANGE_TEST_STEP_RATE = "lr_range_test_step_rate"
LR_RANGE_TEST_STEP_SIZE = "lr_range_test_step_size"
LR_RANGE_TEST_STAIRCASE = "lr_range_test_staircase"

ONE_CYCLE_MIN_LR = "cycle_min_lr"
ONE_CYCLE_MAX_LR = "cycle_max_lr"
ONE_CYCLE_DECAY_LR_RATE = "decay_lr_rate"
ONE_CYCLE_MIN_MOM = "cycle_min_mom"
ONE_CYCLE_MAX_MOM = "cycle_max_mom"
ONE_CYCLE_DECAY_MOM_RATE = "decay_mom_rate"
ONE_CYCLE_FIRST_STEP_SIZE = "cycle_first_step_size"
ONE_CYCLE_SECOND_STEP_SIZE = "cycle_second_step_size"
ONE_CYCLE_FIRST_STAIR_COUNT = "cycle_first_stair_count"
ONE_CYCLE_SECOND_STAIR_COUNT = "cycle_second_stair_count"
ONE_CYCLE_DECAY_STEP_SIZE = "decay_step_size"

WARMUP_MIN_LR = "warmup_min_lr"
WARMUP_MAX_LR = "warmup_max_lr"
WARMUP_NUM_STEPS = "warmup_num_steps"
TOTAL_NUM_STEPS = "total_num_steps"


class _ScheduleBase:
    """Stateful wrapper over a pure step->lr function."""

    def __init__(self, optimizer=None, last_batch_iteration=-1):
        # ``optimizer`` may be an engine-attached optimizer handle (whose lr we
        # set) or None when used standalone.
        self.optimizer = optimizer
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self):
        raise NotImplementedError

    def get_last_lr(self):
        assert getattr(self, "_last_lr", None) is not None, "need to call step() first"
        return self._last_lr

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        lrs = self.get_lr()
        if self.optimizer is not None and hasattr(self.optimizer, "set_lr"):
            self.optimizer.set_lr(lrs[0])
        self._last_lr = lrs
        return lrs

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        """Resume at the saved iteration; the last LR is that iteration's,
        as ``step()`` left it when the state was saved."""
        self.last_batch_iteration = sd["last_batch_iteration"]
        if self.last_batch_iteration >= 0:
            self._last_lr = self.get_lr()


class LRRangeTest(_ScheduleBase):
    """LR range test (reference lr_schedules.py:301): lr ramps from min_lr by
    ``step_rate`` every ``step_size`` steps, continuously or staircase."""

    def __init__(self, optimizer=None, lr_range_test_min_lr=1e-3, lr_range_test_step_size=2000,
                 lr_range_test_step_rate=1.0, lr_range_test_staircase=False, last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        if lr_range_test_step_size <= 0 or not isinstance(lr_range_test_step_size, int):
            raise ValueError("step size must be positive integer")
        if lr_range_test_step_rate < 0:
            raise ValueError("step rate must be positive")
        self.min_lr = lr_range_test_min_lr if isinstance(lr_range_test_min_lr, list) else [lr_range_test_min_lr]
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        self.interval_fn = self._staircase_interval if lr_range_test_staircase else self._continuous_interval

    def _staircase_interval(self):
        return math.floor(float(self.last_batch_iteration + 1) / self.step_size)

    def _continuous_interval(self):
        return float(self.last_batch_iteration + 1) / self.step_size

    def _get_increase(self):
        return 1 + self.step_rate * self.interval_fn()

    def get_lr(self):
        lr_increase = self._get_increase()
        return [lr * lr_increase for lr in self.min_lr]


class OneCycle(_ScheduleBase):
    """1-Cycle schedule (reference lr_schedules.py:408): lr up for
    ``cycle_first_step_size``, down for ``cycle_second_step_size``, then decay."""

    def __init__(self, optimizer=None, cycle_min_lr=0.0, cycle_max_lr=1e-2, decay_lr_rate=0.0,
                 cycle_first_step_size=2000, cycle_second_step_size=None,
                 cycle_first_stair_count=0, cycle_second_stair_count=None,
                 decay_step_size=0, cycle_momentum=True, cycle_min_mom=0.85, cycle_max_mom=0.99,
                 decay_mom_rate=0.0, last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.cycle_first_step_size = cycle_first_step_size
        self.cycle_second_step_size = cycle_second_step_size or cycle_first_step_size
        self.first_stair_count = cycle_first_stair_count
        self.second_stair_count = (
            cycle_first_stair_count if cycle_second_stair_count is None else cycle_second_stair_count
        )
        self.decay_step_size = decay_step_size
        self.total_size = self.cycle_first_step_size + self.cycle_second_step_size
        self.step_ratio = self.cycle_first_step_size / self.total_size
        self.cycle_momentum = cycle_momentum
        self.cycle_min_mom = cycle_min_mom
        self.cycle_max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate

    def _get_cycle_lr(self):
        cycle = math.floor(1 + self.last_batch_iteration / self.total_size)
        x = 1.0 + self.last_batch_iteration / self.total_size - cycle
        if x <= self.step_ratio:
            scale_factor = x / self.step_ratio
        else:
            scale_factor = (x - 1) / (self.step_ratio - 1)
        base_height = (self.cycle_max_lr - self.cycle_min_lr) * scale_factor
        return [self.cycle_min_lr + base_height]

    def _get_decay_lr(self, decay_batch_iteration):
        if self.decay_step_size > 0:
            decay_interval = decay_batch_iteration / self.decay_step_size
        else:
            decay_interval = decay_batch_iteration
        lr_decay_factor = 1 + self.decay_lr_rate * decay_interval
        return [self.cycle_min_lr / lr_decay_factor]

    def get_lr(self):
        if self.last_batch_iteration < self.total_size:
            return self._get_cycle_lr()
        return self._get_decay_lr(self.last_batch_iteration - self.total_size + 1)

    def get_mom(self):
        if not self.cycle_momentum:
            return None
        if self.last_batch_iteration < self.total_size:
            cycle = math.floor(1 + self.last_batch_iteration / self.total_size)
            x = 1.0 + self.last_batch_iteration / self.total_size - cycle
            if x <= self.step_ratio:
                scale_factor = x / self.step_ratio
            else:
                scale_factor = (x - 1) / (self.step_ratio - 1)
            base_height = (self.cycle_max_mom - self.cycle_min_mom) * scale_factor
            return [self.cycle_max_mom - base_height]
        decay_interval = (self.last_batch_iteration - self.total_size + 1)
        if self.decay_step_size > 0:
            decay_interval /= self.decay_step_size
        return [self.cycle_min_mom * (1 + self.decay_mom_rate * decay_interval)]


class WarmupLR(_ScheduleBase):
    """Linear warmup from min to max lr, then constant (reference lr_schedules.py:677)."""

    def __init__(self, optimizer=None, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lrs = [warmup_min_lr] if not isinstance(warmup_min_lr, list) else warmup_min_lr
        self.max_lrs = [warmup_max_lr] if not isinstance(warmup_max_lr, list) else warmup_max_lr
        self.delta_lrs = [big - small for big, small in zip(self.max_lrs, self.min_lrs)]
        self.warmup_num_steps = warmup_num_steps
        self.inverse_log_warm_up = 1.0 / math.log(max(self.warmup_num_steps, 2))

    def _get_gamma(self):
        if self.last_batch_iteration < self.warmup_num_steps:
            return min(1.0, self.inverse_log_warm_up * math.log(self.last_batch_iteration + 1))
        return 1.0

    def get_lr(self):
        if self.last_batch_iteration < 0:
            return [0.0]
        gamma = self._get_gamma()
        return [min_lr + (delta_lr * gamma) for min_lr, delta_lr in zip(self.min_lrs, self.delta_lrs)]


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to zero over total_num_steps (reference lr_schedules.py:761)."""

    def __init__(self, optimizer=None, total_num_steps=1000, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, last_batch_iteration=-1):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps, last_batch_iteration)
        if self.total_num_steps < self.warmup_num_steps:
            logger.warning(
                f"total_num_steps {total_num_steps} is less than warmup_num_steps {warmup_num_steps}"
            )

    def _get_gamma(self):
        if self.last_batch_iteration < self.warmup_num_steps:
            return min(1.0, self.inverse_log_warm_up * math.log(self.last_batch_iteration + 1))
        return max(
            0.0,
            float(self.total_num_steps - self.last_batch_iteration)
            / float(max(1.0, self.total_num_steps - self.warmup_num_steps)),
        )


SCHEDULE_CLASSES = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
}


def get_lr_schedule(name, params, optimizer=None):
    """Instantiate a schedule by config name."""
    if name not in SCHEDULE_CLASSES:
        raise ValueError(f"Unknown lr schedule {name}, valid: {VALID_LR_SCHEDULES}")
    return SCHEDULE_CLASSES[name](optimizer=optimizer, **(params or {}))


def add_tuning_arguments(parser):
    """The convergence-tuning command-line arguments, as the JAX package
    adds them."""
    group = parser.add_argument_group("Convergence Tuning", "Convergence tuning configurations")
    group.add_argument("--lr_schedule", type=str, default=None, help="LR schedule for training.")
    group.add_argument("--lr_range_test_min_lr", type=float, default=0.001)
    group.add_argument("--lr_range_test_step_rate", type=float, default=1.0)
    group.add_argument("--lr_range_test_step_size", type=int, default=1000)
    group.add_argument("--lr_range_test_staircase", type=bool, default=False)
    group.add_argument("--cycle_first_step_size", type=int, default=1000)
    group.add_argument("--cycle_first_stair_count", type=int, default=-1)
    group.add_argument("--cycle_second_step_size", type=int, default=-1)
    group.add_argument("--cycle_second_stair_count", type=int, default=-1)
    group.add_argument("--decay_step_size", type=int, default=1000)
    group.add_argument("--cycle_min_lr", type=float, default=0.01)
    group.add_argument("--cycle_max_lr", type=float, default=0.1)
    group.add_argument("--decay_lr_rate", type=float, default=0.0)
    group.add_argument("--cycle_min_mom", type=float, default=0.8)
    group.add_argument("--cycle_max_mom", type=float, default=0.9)
    group.add_argument("--decay_mom_rate", type=float, default=0.0)
    group.add_argument("--warmup_min_lr", type=float, default=0)
    group.add_argument("--warmup_max_lr", type=float, default=0.001)
    group.add_argument("--warmup_num_steps", type=int, default=1000)
    return parser
