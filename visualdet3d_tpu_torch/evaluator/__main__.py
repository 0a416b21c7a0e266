"""Standalone evaluator CLI (counterpart of
``visualdet3d_tpu/evaluator/__main__.py``; reference
visualDet3D/evaluator/__main__.py):

  python -m visualdet3d_tpu_torch.evaluator kitti_obj --label_path=... \
      --result_path=... --label_split_file=... [--current_classes=0,1]
  python -m visualdet3d_tpu_torch.evaluator kitti_depth --label_path=... --result_path=...
"""
import sys

from visualdet3d_tpu_torch.evaluator.kitti_object.evaluate import evaluate


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    evaluator = argv[0] if argv else 'kitti_obj'
    kwargs = {}
    for a in argv[1:]:
        if a.startswith('--') and '=' in a:
            k, v = a[2:].split('=', 1)
            kwargs[k] = v
    if 'scale' in kwargs:
        kwargs['scale'] = float(kwargs['scale'])
    if 'current_classes' in kwargs:
        kwargs['current_classes'] = [
            int(c) if c.isdigit() else c
            for c in kwargs['current_classes'].split(',')]
    if evaluator.lower() == 'kitti_obj':
        for text in evaluate(**kwargs):
            print(text)
        return
    if evaluator.lower() == 'kitti_depth':
        from visualdet3d_tpu_torch.evaluator.kitti_depth.evaluate_depth import evaluate_depth
        print(evaluate_depth(**kwargs))
        return
    raise NotImplementedError(evaluator)


if __name__ == '__main__':
    main(sys.argv[1:])
