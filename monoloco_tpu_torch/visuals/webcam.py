"""Live webcam localization (`predict --webcam`): the port of
`monoloco_tpu/visuals/webcam.py`.

cv2 capture (a device index, or a video file path through `--camera`) ->
OpenPifPaf poses -> `Loco.forward` on the engine's device, one dispatch a
frame -> post-processing and `--activities` -> the frame's output. cv2 and
openpifpaf are imported when the loop starts, and a clear error names the
one that is missing. The figure outputs draw with matplotlib: live when an
interactive backend loads, else each frame is saved as
`out_webcam_<i>.<type>.png`, as the JAX package does. With `--output_types
json` alone the loop needs neither matplotlib nor Pillow and writes
`out_webcam_<i>.monoloco.json` a frame.
"""

import logging
import time

from ..network import Loco, load_calibration, preprocess_pifpaf

LOG = logging.getLogger(__name__)


def _interactive_pyplot():
    """pyplot on an interactive backend when one loads, else on Agg;
    returns (plt, interactive)."""
    import matplotlib
    interactive = True
    try:
        matplotlib.use('TkAgg', force=True)
    except Exception:
        try:
            matplotlib.use('QtAgg', force=True)
        except Exception:
            interactive = False
            matplotlib.use('Agg', force=True)
    import matplotlib.pyplot as plt
    return plt, interactive


def webcam(args):
    """Run the loop until the capture ends; returns (the engine, the number
    of frames)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("webcam mode requires opencv-python (cv2)") from e
    try:
        import openpifpaf
    except ImportError as e:
        raise ImportError("webcam mode requires openpifpaf for pose estimation") from e

    assert args.mode == 'mono', "webcam streaming supports mono mode only"
    if not args.output_types:
        args.output_types = ['multi']
    figures = args.output_types != ['json']
    plt, interactive = _interactive_pyplot() if figures else (None, False)
    if figures:
        from PIL import Image
        from .printer import Printer
    args.z_max = min(args.z_max, 10)
    long_edge = args.long_edge or 144
    if figures and not interactive:
        LOG.warning('No interactive matplotlib backend: saving frames as '
                    'out_webcam_<n>.png instead of displaying')

    device = 'cpu' if getattr(args, 'disable_cuda', False) else None
    net = Loco(model=args.model, mode=args.mode, net=args.net, device=device,
               n_dropout=args.n_dropout, p_dropout=args.dropout)
    predictor = openpifpaf.Predictor(checkpoint=args.checkpoint)

    cam = cv2.VideoCapture(args.camera)
    if not cam.isOpened():
        raise ValueError(f"cannot open camera source {args.camera!r} "
                         "(device index or video file path)")
    print("Webcam started: press q in the terminal to stop")
    frame_idx = 0
    if figures and interactive:
        plt.ion()
    while True:
        start = time.time()
        ret, frame = cam.read()
        if not ret:
            break
        scale = long_edge / max(frame.shape[0], frame.shape[1])
        image = cv2.resize(frame, None, fx=scale, fy=scale)
        height, width, _ = image.shape
        image_cv = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)

        preds, _, _ = next(iter(predictor.numpy_images([image_cv])))
        annotations = [ann.json_data() for ann in preds]

        kk = load_calibration(args.calibration, (width, height),
                              focal_length=args.focal_length)
        boxes, keypoints = preprocess_pifpaf(annotations, (width, height))
        dic_out = net.forward(keypoints, kk)
        dic_out = net.post_process(dic_out, boxes, keypoints, kk)
        if 'social_distance' in (args.activities or []):
            dic_out = net.social_distance(dic_out, args)
        if 'raise_hand' in (args.activities or []):
            dic_out = net.raising_hand(dic_out, keypoints)

        output_path = f'out_webcam_{frame_idx}'
        if 'json' in args.output_types:
            from ..predict import _write_json
            _write_json(dic_out, output_path)
        if figures:
            pil_image = Image.fromarray(image_cv)
            visualizer = Printer(pil_image, output_path=output_path, kk=kk, args=args)
            visualizer.save = not interactive
            visualizer.close_on_draw = not interactive  # keep figures for plt.pause
            fig_list, axes = visualizer.factory_axes(dic_out)
            visualizer.draw(fig_list, axes, pil_image, dic_out, annotations=annotations)
            if interactive:
                plt.pause(0.001)
                for fig in fig_list:
                    plt.close(fig)
        frame_idx += 1
        print(f'run-time: {(time.time() - start) * 1000:.0f} ms', end='\r')
    return net, frame_idx
