"""The port's configuration tree (a2m_torch/config.py) against a2m's:
``apply_overrides`` and ``config_grid`` give a2m's field values for a2m's
override strings, through every type branch of ``_set_nested``; unknown
fields (the TPU-only ones included) raise ``KeyError``; ``validate``
accepts and refuses what a2m's does, and refuses by name what the port
does not run yet."""

import dataclasses

import pytest

from a2m import config as jconfig
from a2m_torch import config as tconfig

# one override string per type branch of _set_nested (a2m/config.py:337-366)
OVERRIDES = {
    'bool_true': 'data.shuffle=yes',
    'bool_false': 'train.resume=false',
    'bool_one': 'generator.fused_gcn=1',
    'int': 'data.batch_size=4',
    'int_negative': 'mesh.data=-1',
    'float': 'train.lambda_pos=1.0',
    'float_exponent': 'train.controller.g_lr=1e-3',
    'tuple_str': 'data.speakers=oliver,noah',
    'tuple_int': 'data.fs_new=15,30',
    'none_to_int': 'data.max_intervals_per_split=3',
    'none_to_float': 'data.quantile_sample=0.5',
    'none_to_bool': 'train.fused_gcn_eval=true',
    'none_to_none': 'data.num_training_sample=none',
    'none_to_str': 'data.process_index=auto',
    'str': 'train.best_metric=val_pck',
    'str_path': 'train.save_dir=/data/run1',
    'str_empty': 'train.init_from=',
    'nested_dist': 'dist.coordinator=10.0.0.1:8476',
}


def _get(cfg, dotted: str):
    for part in dotted.split('.'):
        cfg = getattr(cfg, part)
    return cfg


def _common_fields(a, b, prefix=''):
    """(path, a value, b value) for every leaf field both trees have."""
    names = ({f.name for f in dataclasses.fields(a)}
             & {f.name for f in dataclasses.fields(b)})
    for name in sorted(names):
        x, y = getattr(a, name), getattr(b, name)
        if dataclasses.is_dataclass(x):
            yield from _common_fields(x, y, f'{prefix}{name}.')
        else:
            yield f'{prefix}{name}', x, y


@pytest.mark.parametrize('item', list(OVERRIDES.values()),
                         ids=list(OVERRIDES))
def test_override_parses_as_a2m(item):
    key = item.partition('=')[0]
    got = tconfig.apply_overrides(tconfig.Config(), [item])
    ref = jconfig.apply_overrides(jconfig.Config(), [item])
    assert _get(got, key) == _get(ref, key)
    assert type(_get(got, key)) is type(_get(ref, key))


def test_defaults_and_all_overrides_agree_field_by_field():
    # the documented differences: prefetch_batches 0 (a2m 2)
    differ = {'train.prefetch_batches'}
    got = tconfig.apply_overrides(tconfig.Config(), list(OVERRIDES.values()))
    ref = jconfig.apply_overrides(jconfig.Config(), list(OVERRIDES.values()))
    fields = list(_common_fields(got, ref))
    assert len(fields) > 90
    for path, x, y in fields:
        if path not in differ:
            assert x == y, path
    for name in ('save_dir', 'save_every_epochs', 'best_metric', 'resume',
                 'init_from', 'compute_dtype', 'log_mfu', 'profile_dir'):
        assert (getattr(tconfig.TrainConfig(), name)
                == getattr(jconfig.TrainConfig(), name)), name
    assert tconfig.BEST_METRICS == jconfig.BEST_METRICS


@pytest.mark.parametrize('item', [
    'nope=1', 'train.nope=1', 'train.controller.nope=1',
    'train.remat=dots', 'train.rng_impl=rbg', 'train.donate_buffers=false',
    'generator.fused_tile=16', 'audio.use_pallas=on'])
def test_unknown_field_raises_key_error(item):
    with pytest.raises(KeyError, match='unknown config field'):
        tconfig.apply_overrides(tconfig.Config(), [item])
    if item.split('=')[0].endswith('nope'):
        with pytest.raises(KeyError, match='unknown config field'):
            jconfig.apply_overrides(jconfig.Config(), [item])


def test_config_grid_matches_a2m():
    grid = {'train.lambda_pos': ['0', '1.0'],
            'data.speakers': ['oliver', 'oliver,noah'],
            'train.best_metric': ['val_g', 'val_pck', 'pos']}
    got = tconfig.config_grid(tconfig.Config(), grid)
    ref = jconfig.config_grid(jconfig.Config(), grid)
    assert len(got) == len(ref) == 12
    for g, r in zip(got, ref):
        for key in grid:
            assert _get(g, key) == _get(r, key)


@pytest.mark.parametrize('items,accepted', [
    ([], True),
    (['train.best_metric=val_pck'], True),
    (['train.best_metric=bogus'], False),
    (['train.lambda_aux=0.5'], False),
    (['train.lambda_aux=0.5', 'discriminator.use_aux_classifier=true'], True),
    (['mesh.data=-1'], True),
], ids=['defaults', 'val_pck', 'bad_metric', 'aux_without_head', 'aux',
        'mesh_all_of_one'])
def test_validate_as_a2m(items, accepted):
    got = tconfig.apply_overrides(tconfig.Config(), items)
    ref = jconfig.apply_overrides(jconfig.Config(), items)
    if accepted:
        assert tconfig.validate(got) is got
        assert jconfig.validate(ref, backend='cpu') is ref
    else:
        with pytest.raises(ValueError):
            tconfig.validate(got)
        with pytest.raises(ValueError):
            jconfig.validate(ref, backend='cpu')


@pytest.mark.parametrize('item,item_id', [
    ('train.compute_dtype=fp16', 'compute_dtype'),
    ('mesh.data=2', 'A13'), ('mesh.model=2', 'A13'),
    ('dist.coordinator=localhost:8476', 'A13'),
    ('dist.num_processes=2', 'A13'), ('dist.auto=true', 'A13')])
def test_validate_refuses_what_the_port_does_not_run(item, item_id):
    cfg = tconfig.apply_overrides(tconfig.Config(), [item])
    with pytest.raises(ValueError, match=item_id):
        tconfig.validate(cfg)
    jconfig.validate(jconfig.apply_overrides(jconfig.Config(), [item]),
                     backend='cpu')
